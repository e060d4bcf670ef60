"""Each mix at toy shapes on the CPU, through the whole harness: set-up, the
window, the traced window and the check against the plain reference; and
with the timed path broken underneath, the check reads `correct` false."""

from __future__ import annotations

import argparse
import time

import numpy as np
import pytest
import torch

from portbench import harness, run

from .conftest import TOY_CELLS, toy_manifest

SEED = 2 ** 31 + 12345  # more than 32 signed bits hold, as a run's seed may be


def _run(toy_root, cell, trace=0, seconds=0.6, seed=SEED):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return run.run(args, manifest=toy_manifest(), roots=(toy_root, harness.HERE),
                   allow_cpu=True, t_start=time.perf_counter())


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_toy_run_reaches_the_reference(toy_root, cell, trace):
    r = _run(toy_root, cell, trace)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "check"
    for name, c in r["check"].items():
        assert c["value"] <= c["limit"], name
    if trace:
        assert r["device"]["window_s"] > 0 and "breakdown" in r
        assert not r["metrics"], "no device metric is read from a CPU run"
    else:
        assert set(r["metrics"]) == {"setup_s", toy_manifest_reports(cell)}


def toy_manifest_reports(cell):
    from .conftest import TOY_MIXES

    return TOY_MIXES[TOY_CELLS[cell][1]]["reports"]


def test_same_seed_same_inputs(toy_root):
    from portbench.entries import seed as entry
    from portbench.run import Ctx

    from .conftest import TOY_MIXES, toy_configs

    cfg, mix = toy_configs()["toy-sharad"], TOY_MIXES["toy-seed"]
    a = entry.setup(Ctx(cfg, mix, SEED, torch.device("cpu")))
    b = entry.setup(Ctx(cfg, mix, SEED, torch.device("cpu")))
    for wa, wb in zip(a.wins, b.wins):
        np.testing.assert_array_equal(wa["seq"], wb["seq"])
    for k in a.sd:
        assert torch.equal(a.sd[k], b.sd[k])


# -- faults planted under the timed path -------------------------------------

def _shift_middle_frame(pred, nclasses):
    """Every node of the middle frame of each (N, T) map moved to the next
    class."""
    out = np.array(pred, copy=True)
    t = out.shape[-1] // 2
    out[..., t] = (out[..., t] + 1) % nclasses
    return out


def test_fault_survey_answer_altered(toy_root, monkeypatch):
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline

    orig = PropagationPipeline.propagate_survey

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        if isinstance(out, tuple):
            return (_shift_middle_frame(out[0], self.nclasses), *out[1:])
        return _shift_middle_frame(out, self.nclasses)

    monkeypatch.setattr(PropagationPipeline, "propagate_survey", altered)
    assert not _run(toy_root, "toy-miguel.survey")["correct"]


def test_fault_seed_answer_altered(toy_root, monkeypatch):
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline

    orig = PropagationPipeline.__call__

    def altered(self, *a, **kw):
        res = orig(self, *a, **kw)
        res.prediction = _shift_middle_frame(res.prediction, self.nclasses)
        return res

    monkeypatch.setattr(PropagationPipeline, "__call__", altered)
    assert not _run(toy_root, "toy-sharad.seed")["correct"]


def test_fault_seed_change_point_altered(toy_root, monkeypatch):
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline

    orig = PropagationPipeline.__call__

    def altered(self, *a, **kw):
        res = orig(self, *a, **kw)
        res.change_idx = 3 if res.change_idx != 3 else 4
        return res

    monkeypatch.setattr(PropagationPipeline, "__call__", altered)
    r = _run(toy_root, "toy-sharad.seed")
    assert not r["correct"] and r["check"]["change_mismatches"]["value"] > 0


def test_fault_reseed_answer_altered(toy_root, monkeypatch):
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline

    orig = PropagationPipeline.reseed

    def altered(self, seg_ref, frame_idx=0, bucket=16):
        res = orig(self, seg_ref, frame_idx, bucket)
        res.prediction[:, -1] = (res.prediction[:, -1] + 1) % self.nclasses
        return res

    monkeypatch.setattr(PropagationPipeline, "reseed", altered)
    assert not _run(toy_root, "toy-miguel.reseed")["correct"]


def test_fault_reseed_splice_lost(toy_root, monkeypatch):
    """The frames before the reseed frame lose the session's map."""
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline

    orig = PropagationPipeline.reseed

    def altered(self, seg_ref, frame_idx=0, bucket=16):
        res = orig(self, seg_ref, frame_idx, bucket)
        res.prediction[:, :frame_idx] = (res.prediction[:, :frame_idx] + 1) % self.nclasses
        return res

    monkeypatch.setattr(PropagationPipeline, "reseed", altered)
    r = _run(toy_root, "toy-miguel.reseed")
    assert not r["correct"] and r["check"]["splice_mismatches"]["value"] > 0


def test_fault_train_state_unchanged(toy_root, monkeypatch):
    """The step returns its state unchanged: Adam never steps."""
    from radar_sounder_crw_tpu_torch.train import CRWTrainer

    orig = CRWTrainer.init_state

    def frozen(self, shape):
        orig(self, shape)
        self.optimizer.step = lambda *a, **kw: None

    monkeypatch.setattr(CRWTrainer, "init_state", frozen)
    r = _run(toy_root, "toy-sharad.train")
    assert not r["correct"]
    assert r["check"]["change_leaf_gap"]["value"] == pytest.approx(1.0)


def test_fault_train_half_batch(toy_root, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from radar_sounder_crw_tpu_torch.train import CRWTrainer

    orig = CRWTrainer.train_step

    def half(self, batch):
        return orig(self, batch[: batch.shape[0] // 2])

    monkeypatch.setattr(CRWTrainer, "train_step", half)
    assert not _run(toy_root, "toy-sharad.train")["correct"]
