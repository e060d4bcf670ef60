"""The UNet cell (entries/unet_train.py) at toy size on the CPU through the
whole harness: it reaches the reference, and with a fault planted under the
timed path (half of each batch, the standard cross-entropy in place of the
job's, Adam's step skipped) the check reads `correct` false. Beside it:
the UNet's arithmetic against PyTorch's own counter, and the readers of the
`crw.unet.*` spans on recorded events, which read None without them."""

from __future__ import annotations

import argparse
import copy
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, run, unet_arith

from .conftest import toy_manifest
from .test_portbench_spans import Event, FakeTrace

SEED = 2 ** 33 + 4567  # more than 32 signed bits hold, as a run's seed may be
CELL = "toy-unet.unet_train"
LIKE = "unet-sharad.unet_train"
READERS = ("unet_fwd_ms", "unet_bwd_ms", "unet_up_ms")


@pytest.fixture
def unet_root(toy_root):
    """The toy root with a UNet cell: 2 radargrams of 32 x 64 cut into 16
    strips of 32 x 16, 14 to train on, batches of 2; the cell's own limits."""
    cfg = json.loads((harness.HERE / "configs" / "unet-sharad.json").read_text())
    cfg.update(name="toy-unet", rows=32, width=64, strip=[32, 16], batch_size=2)
    (toy_root / "configs" / "toy-unet.json").write_text(json.dumps(cfg))
    mix = json.loads((harness.HERE / "traffic" / "unet_train.json").read_text())
    (toy_root / "traffic" / "toy-unet-train.json").write_text(
        json.dumps(dict(mix, trace_seconds=0.5)))
    (toy_root / "limits" / f"{CELL}.json").write_text(
        (harness.HERE / "limits" / f"{LIKE}.json").read_text())
    return toy_root


def _manifest():
    m = copy.deepcopy(toy_manifest())
    m["workloads"].append({"name": CELL, "config": "toy-unet", "traffic": "toy-unet-train",
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
def test_toy_unet_cell_reaches_the_reference(unet_root, trace):
    r = _run(unet_root, trace)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["check"]) == {"loss_rel_gap", "grad_leaf_gap", "change_leaf_gap"}
    if trace:
        assert not r["metrics"], "no device metric is read from a CPU run"
    else:
        assert set(r["metrics"]) == {"setup_s", "train_steps_per_s"}


def test_fault_half_batch(unet_root, monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from radar_sounder_crw_tpu_torch.train.unet_trainer import UNetTrainer

    orig = UNetTrainer.train_step
    monkeypatch.setattr(UNetTrainer, "train_step",
                        lambda self, x, y: orig(self, x[: len(x) // 2], y[: len(y) // 2]))
    assert not _run(unet_root)["correct"]


def test_fault_standard_cross_entropy(unet_root, monkeypatch):
    """The logits go into the cross-entropy once, not soft-maxed first."""
    from radar_sounder_crw_tpu_torch.train.unet_trainer import UNetTrainer

    orig = UNetTrainer.init_state

    def plain(self, shape):
        orig(self, shape)
        self.config.quirk_double_softmax = False

    monkeypatch.setattr(UNetTrainer, "init_state", plain)
    r = _run(unet_root)
    assert not r["correct"] and r["check"]["loss_rel_gap"]["value"] > 1e-2


def test_fault_step_skipped(unet_root, monkeypatch):
    """Adam never steps: the state is returned unchanged."""
    from radar_sounder_crw_tpu_torch.train.unet_trainer import UNetTrainer

    orig = UNetTrainer.init_state

    def frozen(self, shape):
        orig(self, shape)
        self.optimizer.step = lambda *a, **kw: None

    monkeypatch.setattr(UNetTrainer, "init_state", frozen)
    r = _run(unet_root)
    assert not r["correct"]
    assert r["check"]["change_leaf_gap"]["value"] == pytest.approx(1.0)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("hw", [(32, 16), (36, 20)])
def test_unet_arith_matches_the_flop_counter(hw):
    """Forward, and forward with backward, of the program's UNet (the
    strips need no gradient); odd sizes (36 x 20 -> 9 x 5 -> 4 x 2) pad the
    skips."""
    from radar_sounder_crw_tpu_torch.models import UNet

    model = UNet(1, 5).train()
    x = torch.randn(2, 1, *hw)
    assert _count(lambda: model(x)) == 2 * unet_arith.forward_flops(*hw)
    assert _count(lambda: model(x).sum().backward()) == unet_arith.train_step_flops(2, *hw)


def test_unet_step_total():
    """B 64 of 912 x 64: 53.9 GFLOP a strip's forward, 10.34 TFLOP a step."""
    assert round(unet_arith.forward_flops(912, 64) / 1e9, 1) == 53.9
    assert round(unet_arith.train_step_flops(64, 912, 64) / 1e12, 2) == 10.34


def _trace(events, requests=2):
    t = FakeTrace(events, 0, 1000, [(0, 1000)])
    t.requests = requests
    return t


def _read(name, trace):
    return harness.reader(f"{name}.unet_train")(trace, None)


def test_unet_readers_on_recorded_events():
    """A step's phases, each launching one kernel; the up span nested in the
    forward takes its kernel."""
    ev = [
        Event("crw.unet.forward", "cpu_op", 0, 300, corr=1),
        Event("crw.unet.up", "cpu_op", 100, 200, corr=2),
        Event("fwd_kernel", "kernel", 10, 60, corr=501, linked=1),
        Event("up_kernel", "kernel", 110, 130, corr=502, linked=2),
        Event("crw.unet.loss", "cpu_op", 300, 350, corr=3),
        Event("loss_kernel", "kernel", 300, 305, corr=503, linked=3),
        Event("crw.unet.backward", "cpu_op", 350, 900, corr=4),
        Event("aten::conv_bwd", "cpu_op", 360, 380, thread=2, corr=5),
        Event("bwd_kernel", "kernel", 360, 760, corr=504, linked=5),
    ]
    t = _trace(ev)
    assert _read("unet_fwd_ms", t) == pytest.approx(1e3 * 70e-9 / 2)
    assert _read("unet_up_ms", t) == pytest.approx(1e3 * 20e-9 / 2)
    assert _read("unet_bwd_ms", t) == pytest.approx(1e3 * 400e-9 / 2)


def test_unet_readers_read_none_without_their_spans():
    """A program without the `crw.unet.*` spans (the parent's): the kernels
    belong to another span or to none."""
    ev = [Event("crw.encode", "cpu_op", 0, 300, corr=1),
          Event("conv_kernel", "kernel", 10, 60, corr=501, linked=1),
          Event("unlinked_kernel", "kernel", 400, 420, corr=502)]
    for events in (ev, []):
        for name in READERS:
            assert _read(name, _trace(events)) is None, name
