"""`steps_per_dispatch` in the port (radar_sounder_crw_tpu_torch/train/
crw_trainer.py, train/step_graph.py) on the CPU, where a chunk of k steps
runs eagerly: the same arithmetic as k plain steps.

  * k = 3 equals k = 1 bit for bit through `fit` (two epochs of seven
    batches: two chunks and a tail of one partial batch), on the host and
    the resident batch paths, for the CNN and the ResNet with `fused` and
    `lean` BatchNorms; `train_chunk` equals k `train_step` calls.
  * The CNN's losses through chunks of three against the JAX trainer at
    steps_per_dispatch = 1, by tests/test_torch_train.py's rule (relative
    5e-6 for the first 4 steps, 2e-4 throughout). The JAX package's own
    test holds its k = 3 to its k = 1 (tests/test_train.py), and its scan
    is not compiled here (slow on XLA:CPU).
  * A dropped k = 3 trainer is freed at once, with the cyclic collector
    off: no reference cycle holds it (nor, on the card, its graph).
  * `cli.train --steps_per_dispatch 3` runs, and a run resumed from its
    checkpoint ends with the encoder of an uninterrupted one, bit for bit.

The graph itself (one replay of k captured steps against k eager steps,
bit for bit under deterministic cuDNN) is a card test in
tests/test_torch_cuda.py.
"""

import contextlib
import gc
import io
import os
import weakref

import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu_torch.cli import train as port_train
from radar_sounder_crw_tpu_torch.data import RGWindows, load_pt, synthetic_radargram
from radar_sounder_crw_tpu_torch.train import CheckpointManager, CRWTrainConfig, CRWTrainer
from radar_sounder_crw_tpu_torch.train import step_graph
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from test_torch_train import LR, TAU, _batches, _jax_trainer, _port_trainer, _rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_ROOT = os.path.join(REPO, "tests", "fixtures", "data_root")


def _dataset():
    """13 windows of T = 6, N = 4: seven batches of 2, the last partial."""
    rg, _ = synthetic_radargram(H=40, W=300, seed=7)
    return RGWindows(rg, length=6, dim=(16, 16), overlap=(8, 0))


def _trainer(ds, k, **kw):
    trainer = CRWTrainer(CRWTrainConfig(batch_size=2, epochs=2, lr=LR, tau=TAU,
                                        steps_per_dispatch=k, **kw), device="cpu")
    trainer.init_state(ds[0].shape)
    return trainer


@pytest.mark.parametrize("model,fused_bn,resident", [
    (0, None, False), (0, None, True), (1, "fused", True), (1, "lean", False)])
def test_chunks_equal_plain_steps(model, fused_bn, resident):
    ds = _dataset()
    runs = {}
    for k in (1, 3):
        trainer = _trainer(ds, k, model=model, fused_bn=fused_bn, device_resident=resident)
        runs[k] = (trainer.fit(ds, log=lambda s: None), trainer)
    (want, plain), (got, chunked) = runs[1], runs[3]
    assert got == want
    assert chunked.step == plain.step == 14
    assert chunked._chunks and not plain._chunks  # the chunks ran through their buffers
    for k, v in plain.model.state_dict().items():
        assert torch.equal(chunked.model.state_dict()[k], v), k
    for i, state in plain.optimizer.state_dict()["state"].items():
        for k, v in state.items():
            assert torch.equal(chunked.optimizer.state_dict()["state"][i][k], v), (i, k)


def test_train_chunk_equals_train_steps():
    ds = _dataset()
    batches = np.stack([np.stack([ds[i], ds[i + 1]]) for i in (0, 2, 4)])
    chunked, plain = _trainer(ds, 3, model=1, fused_bn="fused"), _trainer(ds, 3, model=1,
                                                                          fused_bn="fused")
    replays = step_graph.replays
    got = chunked.train_chunk(batches)
    want = torch.stack([plain.train_step(b) for b in batches])
    assert torch.equal(got, want) and got.shape == (3,)
    assert chunked.step == 3 and step_graph.replays == replays  # no graph on the CPU
    assert not any(torch.equal(a, b) for a, b in zip(
        chunked.train_chunk(batches[:, ::-1].copy()), got))


@pytest.mark.parametrize("resident", [False, True])
def test_a_dropped_trainer_is_freed_without_the_cyclic_collector(resident):
    """A k = 3 trainer after `fit` holds its chunks (static buffers and a
    StepGraph whose body runs the steps); the body refers to the step, not
    to the trainer, so `del` frees the trainer (and on the card its graph
    and the graph's memory pool) with the cyclic collector off."""
    ds = _dataset()
    gc.disable()
    try:
        trainer = _trainer(ds, 3, model=1, fused_bn="fused", device_resident=resident)
        trainer.fit(ds, log=lambda s: None)
        assert trainer._chunks
        ref = weakref.ref(trainer)
        del trainer
        assert ref() is None
    finally:
        gc.enable()


def test_cnn_chunks_match_jax():
    B, T, N, H, W = 2, 5, 6, 16, 16
    batches = _batches(12, (B, T, N, H, W), seed=0)
    jt = _jax_trainer((T, N, H, W), model=0, batch_size=B)
    pt = _port_trainer((T, N, H, W), jt.variables(), model=0, batch_size=B, steps_per_dispatch=3)
    want = [float(jt.train_step(b)) for b in batches]
    got = [float(v) for c in range(4) for v in pt.train_chunk(np.stack(batches[3 * c:3 * c + 3]))]
    rel = _rel(got, want)
    assert np.all(rel[:4] < 5e-6), rel[:4]
    assert np.all(rel < 2e-4), rel
    assert pt.step == int(jt.state.step) == 12


TRAIN_FLAGS = ["--model", "0", "--dataset", "0", "--patch_size", "16", "16", "--overlap", "0",
               "0", "--seq_length", "4", "--batch_size", "4", "--device", "cpu", "--no_plots",
               "--steps_per_dispatch", "3"]


def _run(argv):
    args = port_train.get_args_parser().parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = port_train.main(args)
    return out.getvalue(), trainer


def test_cli_train_steps_per_dispatch_runs_and_resumes(tmp_path, monkeypatch):
    """One epoch with a checkpoint, then --resume for one more, against two
    epochs in one run: the same step count and the same encoder file."""
    monkeypatch.setenv("RSCRW_DATA_ROOT", FIXTURE_ROOT)
    ckpt = str(tmp_path / "ckpt")
    common = [*TRAIN_FLAGS, "--output_name", "enc"]
    text, whole = _run([*common, "--epochs", "2", "--output_folder", str(tmp_path / "whole")])
    assert "Finished training." in text.splitlines()
    assert whole.config.steps_per_dispatch == 3 and whole._chunks
    steps = whole.step // 2
    assert steps >= 3
    _, first = _run([*common, "--epochs", "1", "--output_folder", str(tmp_path / "split"),
                     "--ckpt_dir", ckpt])
    assert first.step == steps and CheckpointManager(ckpt).latest_step() == steps
    text, resumed = _run([*common, "--epochs", "1", "--output_folder", str(tmp_path / "split"),
                          "--ckpt_dir", ckpt, "--resume"])
    assert f"Resumed from step {steps}" in text.splitlines()
    assert resumed.step == whole.step
    want = load_pt(str(tmp_path / "whole" / "models" / "enc.pt"))
    got = load_pt(str(tmp_path / "split" / "models" / "enc.pt"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
