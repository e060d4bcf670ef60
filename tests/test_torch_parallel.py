"""The port's data parallel (radar_sounder_crw_tpu_torch/parallel/, the mesh
argument of the trainers and the survey) on the CPU: two gloo ranks against
one process, and against the JAX package on a 2-device mesh.

The ranks run in processes of their own (torch.multiprocessing.spawn, the
process group through a file under tmp_path), all the checks of
tests/_torch_parallel_worker.py in one spawn, joined with a timeout.

Tolerances, from tests/test_train.py where they hold: losses within rtol
1e-5, parameters within rtol 1e-4 / atol 1e-6, running statistics within
rtol 1e-5 / atol 1e-7. Measured here, three things qualify them. Adam's
first updates, lr * m / (sqrt(v) + eps), turn float noise in a gradient
near eps = 1e-8 (or in two steps' gradients that cancel) into up to +-lr,
so parameters are held where every gradient Adam received is at least
1e-6, and the gradients themselves (the all-reduce's output) within 1e-4 of
their tensor's largest magnitude, +1e-6, but for the bias before `bn0`,
whose exact gradient is 0 and whose computed one is noise of either sign. The one-pass batch variance loses digits to cancellation:
reversing the batch in one process moves the ResNet's gradients by up to
5.7e-2 of their scale and its running statistics by up to 1.07e-6 (three
seeds), so with it the whole networks' statistics are held at atol 1e-6
and their gradients and parameters are left to a BatchNorm alone on an input
it is well conditioned for (mean 0.3, std 1): its output, its gradients and
its running statistics, one- and two-pass, within rtol 1e-5 / atol 1e-6. A batch the mesh does not divide runs whole on each rank: every number
equals the one process's exactly, and every rank holds the same numbers.
The survey's maps, xent maps and change indices are exactly equal. Against
JAX, as tests/test_torch_train.py holds one step: the CNN's losses within
relative 5e-6, the two-pass ResNet's loss within rtol 5e-5 and its running
statistics within rtol 1e-3 / atol 1e-3 x max.
"""

import contextlib
import io
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from radar_sounder_crw_tpu.models.torch_import import export_state_dict
from radar_sounder_crw_tpu.parallel import make_mesh as jax_make_mesh
from radar_sounder_crw_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from radar_sounder_crw_tpu.parallel.mesh import shard_batch as jax_shard_batch
from radar_sounder_crw_tpu.train import CRWTrainConfig as JaxConfig
from radar_sounder_crw_tpu.train import CRWTrainer as JaxTrainer
from radar_sounder_crw_tpu_torch.cli import train as port_train
from radar_sounder_crw_tpu_torch.data import load_pt
from radar_sounder_crw_tpu_torch.models import state_dict_from_jax
from radar_sounder_crw_tpu_torch.parallel import Mesh, make_mesh, pad_to_multiple, shard_batch
import _torch_parallel_worker as worker
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_ROOT = os.path.join(REPO, "tests", "fixtures", "data_root")
JOIN_S = 240


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_pad_and_shard_equal_jax():
    """pad_to_multiple and shard_batch on numpy equal the JAX package's (its
    shard on device r is this port's rank r); a tensor pads to the same
    values; a size the mesh does not divide raises on both sides."""
    rng = np.random.default_rng(0)
    for b in (1, 3, 4, 5, 8):
        x = rng.standard_normal((b, 3, 2)).astype(np.float32)
        for multiple in (1, 2, 3, 4):
            got, real = pad_to_multiple(x, multiple)
            want, want_real = jax_pad_to_multiple(x, multiple)
            np.testing.assert_array_equal(got, want)
            assert real == want_real == b
            padded, _ = pad_to_multiple(torch.as_tensor(x), multiple)
            np.testing.assert_array_equal(padded.numpy(), want)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    for n in (1, 2, 4, 8):
        shards = jax_shard_batch(x, jax_make_mesh(jax.devices()[:n])).addressable_shards
        want = {s.device: np.asarray(s.data) for s in shards}
        for r, dev in enumerate(jax.devices()[:n]):
            mesh = Mesh(torch.device("cpu"), None, n, r)
            np.testing.assert_array_equal(shard_batch(x, mesh), want[dev])
            np.testing.assert_array_equal(shard_batch(torch.as_tensor(x), mesh).numpy(), want[dev])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(x[:5], Mesh(torch.device("cpu"), None, 2, 0))
    with pytest.raises(ValueError, match="not divisible"):
        jax_shard_batch(x[:5], jax_make_mesh(jax.devices()[:2]))
    assert make_mesh(["cpu"]) == Mesh(torch.device("cpu"))
    with pytest.raises(ValueError, match="without a process group"):
        make_mesh(["cpu", "cpu"])


def _jax_two_devices():
    """The JAX trainers' inits (as port state dicts) and their steps on a
    2-device mesh: the CNN's sharded and whole step, the two-pass ResNet's
    sharded step."""
    mesh = jax_make_mesh(jax.devices()[:2])
    runs = {}
    for name, model, kw, sizes in (("cnn", 0, {}, (worker.SHARDED, worker.WHOLE)),
                                   ("resnet", 1, {"fused_bn": "twopass"}, (worker.SHARDED,))):
        trainer = JaxTrainer(JaxConfig(model=model, lr=worker.LR, tau=worker.TAU,
                                       device_resident=False, **kw), mesh=mesh)
        trainer.init_state(worker.ITEM)
        init = state_dict_from_jax(_np(trainer.variables()))
        losses = [float(trainer.train_step(b)) for b in worker.batches(sizes, worker.ITEM)]
        runs[name] = (init, losses, export_state_dict(_np(trainer.variables())))
    return runs


def _spawn(fn, args, nprocs):
    """torch.multiprocessing.spawn, joined within JOIN_S seconds."""
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks did not finish within {JOIN_S} s")


# a bias that a BatchNorm follows: its exact gradient is 0, its computed one
# float noise of either sign
ZERO_GRADIENT = {"fc0.bias"}


def _assert_grads_close(got, want):
    for n, g in want.items():
        if n in ZERO_GRADIENT:
            continue
        scale = float(g.abs().max())
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=0, atol=1e-4 * scale + 1e-6,
                                   err_msg=n)


def _assert_params_close(got, want, grads):
    """Parameters within rtol 1e-4 / atol 1e-6 where every gradient Adam
    received (`grads`, one dict a step) is at least 1e-6."""
    held = 0
    for n in grads[0]:
        mask = torch.stack([g[n].abs() >= 1e-6 for g in grads]).all(0)
        held += int(mask.sum())
        np.testing.assert_allclose(got[n][mask].numpy(), want[n][mask].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)
    assert held > 10_000, held


def _assert_stats_close(got, want, atol):
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=atol,
                                   err_msg=k)


def _assert_equal_runs(got, want):
    assert got["losses"] == want["losses"]
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
    for g_got, g_want in zip(got["grads"], want["grads"]):
        for k, v in g_want.items():
            assert torch.equal(g_got[k], v), k


def test_two_ranks_equal_one_rank_and_jax(tmp_path):
    jax_runs = _jax_two_devices()
    inits = {"cnn": jax_runs["cnn"][0], "resnet": jax_runs["resnet"][0]}
    torch.save(inits, tmp_path / "inits.pt")
    _spawn(worker.rank_main, (2, str(tmp_path / "init"), str(tmp_path)), 2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    one = worker.run_checks(make_mesh(["cpu"]), inits)
    assert [r["mesh"] for r in ranks] == [(2, 0, "cpu"), (2, 1, "cpu")]

    # every rank holds the same result
    for name in one:
        if name not in ("survey", "bn"):
            _assert_equal_runs(ranks[1][name], ranks[0][name])
    two = ranks[0]

    # sharded steps (the CNN's is followed by a whole one): losses, the
    # summed gradients, parameters, running statistics
    for name, exact_grads, stats_atol in (
            ("cnn", True, None), ("resnet_twopass_remat_sharded", True, 1e-7),
            ("resnet_sharded", False, 1e-6), ("unet_sharded", False, 1e-6)):
        got, want = two[name], one[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        if exact_grads:
            for g_got, g_want in zip(got["grads"], want["grads"]):
                _assert_grads_close(g_got, g_want)
            _assert_params_close(got["state"], want["state"], want["grads"])
        if stats_atol is not None:
            _assert_stats_close(got["state"], want["state"], stats_atol)
    # one BatchNorm: this rank's rows of the output and the input gradient,
    # the summed weight and bias gradients, the running statistics
    for twopass in (False, True):
        for r, rank in enumerate(ranks):
            got, want = rank["bn"][twopass], one["bn"][twopass]
            rows = slice(4 * r, 4 * r + 4)
            for k in got:
                full = k in ("y", "x_grad")
                np.testing.assert_allclose(got[k].numpy(), want[k][rows].numpy() if full
                                           else want[k].numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k} twopass={twopass}")
    # a batch the mesh does not divide: no collective, the same arithmetic
    _assert_equal_runs(two["resnet_whole"], one["resnet_whole"])
    _assert_equal_runs(two["unet_whole"], one["unet_whole"])
    for name in ("unet_sharded", "unet_whole"):
        np.testing.assert_array_equal(two[name]["predict"], one[name]["predict"])
        assert two[name]["predict"].shape == (worker.UNET_PREDICT, *worker.UNET_HW)

    # the survey over two ranks (R = 5 padded to 6)
    for key in ("pred", "rev", "xent"):
        np.testing.assert_array_equal(two["survey"][key], one["survey"][key], err_msg=key)
        np.testing.assert_array_equal(ranks[1]["survey"][key], two["survey"][key])
    assert two["survey"]["pred"].shape[0] == worker.SURVEY_R
    assert two["survey"]["change"] == ranks[1]["survey"]["change"] == one["survey"]["change"]

    # against the JAX trainer on a 2-device mesh
    _, jax_cnn_losses, _ = jax_runs["cnn"]
    rel = np.abs(np.subtract(two["cnn"]["losses"], jax_cnn_losses)) / np.abs(jax_cnn_losses)
    assert np.all(rel < 5e-6), rel
    _, jax_resnet_losses, jax_resnet = jax_runs["resnet"]
    got = two["resnet_twopass_remat_sharded"]
    np.testing.assert_allclose(got["losses"], jax_resnet_losses, rtol=5e-5)
    for k, want in jax_resnet.items():
        if k.endswith(("running_mean", "running_var")):
            scale = float(np.max(np.abs(want))) or 1.0
            np.testing.assert_allclose(got["state"][k].numpy(), want, rtol=1e-3,
                                       atol=1e-3 * scale, err_msg=k)


def test_a_group_of_one_rank_is_the_identity(tmp_path):
    """Under a process group of one rank every batch runs sharded, with all
    the collectives; they are the identity: a ResNet step (one- and
    two-pass) and a UNet step equal the mesh-free ones bit for bit, as
    chip_smoke.py holds them on the card over NCCL."""
    import torch.distributed as dist

    inits = {"resnet": worker.create_model(1, False, device="cpu", seed=3).state_dict()}
    alone = Mesh(torch.device("cpu"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        group = make_mesh()
        assert group.group is not None and group.size == 1
        for kw in ({}, {"fused_bn": "twopass", "remat": True}):
            _assert_equal_runs(worker.crw_run(group, 1, inits["resnet"], (worker.SHARDED,), **kw),
                               worker.crw_run(alone, 1, inits["resnet"], (worker.SHARDED,), **kw))
        got, want = worker.unet_run(group, worker.UNET_SHARDED), worker.unet_run(alone,
                                                                                 worker.UNET_SHARDED)
        _assert_equal_runs(got, want)
        np.testing.assert_array_equal(got["predict"], want["predict"])
    finally:
        dist.destroy_process_group()


TRAIN_FLAGS = ["--model", "0", "--dataset", "0", "--dataset_full", "0", "--patch_size", "16",
               "16", "--overlap", "0", "0", "--seq_length", "4", "--batch_size", "4", "--epochs",
               "1", "--device", "cpu", "--no_plots", "--output_name", "dp"]


def test_cli_train_two_ranks_equals_one_process(tmp_path, monkeypatch):
    """`torch.distributed.run --nproc_per_node 2 -m ...cli.train --device
    cpu`, four sharded steps: rank 0 alone prints; the epoch loss equals the
    one-process run's within rtol 1e-5, and each tensor of the exported
    encoder within relative 1e-4 in the Frobenius norm (measured 1.8e-6 at
    most; elementwise, Adam can turn noise in a gradient near zero into a
    jump of up to lr, see the module docstring)."""
    monkeypatch.setenv("RSCRW_DATA_ROOT", FIXTURE_ROOT)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "radar_sounder_crw_tpu_torch.cli.train", *TRAIN_FLAGS,
         "--output_folder", str(tmp_path / "two")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=JOIN_S,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines.count("Finished training.") == 1, proc.stdout
    epochs = [ln for ln in lines if ln.startswith("Epoch: 0 Loss: ")]
    assert len(epochs) == 1, proc.stdout

    args = port_train.get_args_parser().parse_args(
        [*TRAIN_FLAGS, "--output_folder", str(tmp_path / "one")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = port_train.main(args)
    assert trainer.mesh.size == 1 and trainer.step > 1
    one_epoch = [ln for ln in out.getvalue().splitlines() if ln.startswith("Epoch: 0 Loss: ")]
    np.testing.assert_allclose(float(epochs[0].split()[3]), float(one_epoch[0].split()[3]),
                               rtol=1e-5)
    got = load_pt(tmp_path / "two" / "models" / "dp.pt")
    want = load_pt(tmp_path / "one" / "models" / "dp.pt")
    assert set(got) == set(want)
    for k, v in want.items():
        assert float((got[k] - v).norm() / v.norm()) < 1e-4, k
