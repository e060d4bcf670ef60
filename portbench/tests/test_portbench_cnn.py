"""The CNN cell (entries/cnn_train.py) at toy size on the CPU through the
whole harness: it reaches the reference, and with a fault planted under the
timed path (half of each batch, Adam's step skipped) the check reads
`correct` false. Beside it: the CNN's arithmetic against PyTorch's own
counter, and the reader of the pools' forward and backward operators, which
reads None without them."""

from __future__ import annotations

import argparse
import copy
import json
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import cnn_arith, harness, run

from .conftest import toy_manifest

SEED = 2 ** 33 + 7654  # more than 32 signed bits hold, as a run's seed may be
CELL = "toy-cnn.cnn_train"
LIKE = "cnn-sharad.cnn_train"


@pytest.fixture
def cnn_root(toy_root):
    """The toy root with a CNN cell: one radargram of 40 x 400 (N 4, 50
    windows of T 4), batches of 2; the cell's own limits."""
    cfg = json.loads((harness.HERE / "configs" / "cnn-sharad.json").read_text())
    cfg.update(name="toy-cnn", rows=40, width=400,
               train=dict(cfg["train"], batch_size=2, seq_length=4))
    (toy_root / "configs" / "toy-cnn.json").write_text(json.dumps(cfg))
    mix = json.loads((harness.HERE / "traffic" / "cnn_train.json").read_text())
    (toy_root / "traffic" / "toy-cnn-train.json").write_text(
        json.dumps(dict(mix, trace_seconds=0.5)))
    (toy_root / "limits" / f"{CELL}.json").write_text(
        (harness.HERE / "limits" / f"{LIKE}.json").read_text())
    return toy_root


def _manifest():
    m = copy.deepcopy(toy_manifest())
    m["workloads"].append({"name": CELL, "config": "toy-cnn", "traffic": "toy-cnn-train",
                           "chips": 1, "why": "toy"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if LIKE in metric.get("workloads", ()):
            metric["workloads"].append(CELL)
    return m


def _run(root, trace=0):
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.6, trace=trace)
    return run.run(args, manifest=_manifest(), roots=(root, harness.HERE), allow_cpu=True,
                   t_start=time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
def test_toy_cnn_cell_reaches_the_reference(cnn_root, trace):
    r = _run(cnn_root, trace)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["check"]) == {"loss_rel_gap", "grad_leaf_gap", "change_leaf_gap"}
    if trace:
        assert not r["metrics"], "no device metric is read from a CPU run"
    else:
        assert set(r["metrics"]) == {"setup_s", "train_steps_per_s"}


def test_fault_half_batch(cnn_root, monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from radar_sounder_crw_tpu_torch.train import CRWTrainer

    orig = CRWTrainer.train_step
    monkeypatch.setattr(CRWTrainer, "train_step",
                        lambda self, batch: orig(self, batch[: len(batch) // 2]))
    assert not _run(cnn_root)["correct"]


def test_fault_step_skipped(cnn_root, monkeypatch):
    """Adam never steps: the state is returned unchanged."""
    from radar_sounder_crw_tpu_torch.train import CRWTrainer

    orig = CRWTrainer.init_state

    def frozen(self, shape):
        orig(self, shape)
        self.optimizer.step = lambda *a, **kw: None

    monkeypatch.setattr(CRWTrainer, "init_state", frozen)
    r = _run(cnn_root)
    assert not r["correct"]
    assert r["check"]["change_leaf_gap"]["value"] == pytest.approx(1.0)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("hw", [(16, 16), (20, 12)])
def test_cnn_arith_matches_the_flop_counter(hw):
    """Forward, and forward with backward, of the program's CNN (the
    patches need no gradient)."""
    from radar_sounder_crw_tpu_torch.models import create_model

    model = create_model(0, False, device="cpu").train()
    x = torch.randn(3, 1, *hw)
    assert _count(lambda: model(x)) == 3 * cnn_arith.encoder_flops(*hw)
    assert _count(lambda: model(x).sum().backward()) == \
        3 * cnn_arith.encoder_flops(*hw, backward=True)


def test_cnn_step_total():
    """16 x 16 patches: 49.58 MFLOP a forward, 96.7 % of it the three 3x3
    convolutions at 10 x 10; B 8, T 20, N 113: 2.693 TFLOP a step."""
    assert round(cnn_arith.encoder_flops() / 1e6, 2) == 49.58
    per = {name: 2 * ci * co * k * k * oh * ow
           for name, ci, co, k, oh, ow in cnn_arith.cnn_layers()}
    share = sum(per[n] for n in ("conv3", "conv4", "conv5")) / cnn_arith.encoder_flops()
    assert round(100 * share, 1) == 96.7
    assert round(cnn_arith.train_step_flops(8, 20, 113) / 1e12, 3) == 2.693


def _trace(op_seconds, requests=2):
    return types.SimpleNamespace(requests=requests, op_device_seconds=op_seconds)


def _read(trace):
    return harness.reader("cnn_pool_ms.cnn_train")(trace, None)


def test_cnn_pool_reader_sums_both_operators():
    """The pools' forward and backward operators, and nothing else."""
    ops = {"aten::max_pool2d_with_indices": 50e-9,
           "aten::max_pool2d_with_indices_backward": 100e-9, "aten::convolution": 70e-9}
    assert _read(_trace(ops)) == pytest.approx(1e3 * (50e-9 + 100e-9) / 2)
    del ops["aten::max_pool2d_with_indices"]
    assert _read(_trace(ops)) == pytest.approx(1e3 * 100e-9 / 2)


def test_cnn_pool_reader_reads_none_without_either_operator():
    for ops in ({"aten::convolution": 50e-9}, {}):
        assert _read(_trace(ops)) is None
    assert _read(_trace({"aten::max_pool2d_with_indices": 50e-9}, requests=0)) is None
