"""The port's CRW trainer (radar_sounder_crw_tpu_torch/train/) vs the JAX
one (radar_sounder_crw_tpu/train/crw_trainer.py), CPU, float32.

Both sides start from the JAX init (variables -> `state_dict_from_jax`, so
the port loads them with strict=True) and run the same batches. JAX runs on
a one-device mesh. Tolerances, as tests/test_reference_train_trajectory.py
sets them for the reference loop: per-step losses within relative 5e-6 for
the first 4 steps and 2e-4 throughout (backend float noise grows through
the optimization); one ResNet step's loss within rtol 5e-5 (two-pass
variance; 5e-4 one-pass, see the test) and its 13
BatchNorms' running statistics within rtol 1e-3 with atol 1e-3 x the
stat's largest magnitude; the epoch means of `fit` within relative 2e-4.
The resident and host batch paths are compared with each other exactly:
on the CPU they do the same arithmetic. The trainer's other paths are in
tests/test_torch_train_paths.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.data import RGWindows as JaxRGWindows
from radar_sounder_crw_tpu.models.torch_import import export_state_dict
from radar_sounder_crw_tpu.parallel import make_mesh
from radar_sounder_crw_tpu.train import CRWTrainConfig as JaxConfig
from radar_sounder_crw_tpu.train import CRWTrainer as JaxTrainer
from radar_sounder_crw_tpu_torch.data import RGWindows, synthetic_radargram
from radar_sounder_crw_tpu_torch.models import state_dict_from_jax
from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

LR, TAU = 1e-3, 0.05


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_trainer(shape, **kw):
    trainer = JaxTrainer(JaxConfig(lr=LR, tau=TAU, device_resident=False, **kw),
                         mesh=make_mesh(jax.devices()[:1]))
    trainer.init_state(shape)
    return trainer


def _port_trainer(shape, variables, **kw):
    kw.setdefault("device_resident", False)
    trainer = CRWTrainer(CRWTrainConfig(lr=LR, tau=TAU, **kw), device="cpu")
    trainer.init_state(shape)
    trainer.model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return trainer


def _port_trainer_like(trainer, **kw):
    """A port trainer from the same init as `trainer` (a port one)."""
    cfg = CRWTrainConfig(**{**trainer.config.__dict__, **kw})
    other = CRWTrainer(cfg, device="cpu")
    other.init_state(trainer._init_shape)
    other.model.load_state_dict(trainer.model.state_dict(), strict=True)
    return other


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want))


@functools.lru_cache(maxsize=None)
def _radargram():
    rg, _ = synthetic_radargram(H=120, W=800, seed=7)
    return rg


def _dataset(rg=None):
    return RGWindows(_radargram() if rg is None else rg, length=6, dim=(16, 16), overlap=(8, 0))


def _batches(K, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * 0.5 for _ in range(K)]


def test_cnn_trajectory_matches_jax():
    B, T, N, H, W = 2, 5, 6, 16, 16
    batches = _batches(12, (B, T, N, H, W), seed=0)
    jt = _jax_trainer((T, N, H, W), model=0, batch_size=B)
    pt = _port_trainer((T, N, H, W), jt.variables(), model=0, batch_size=B)
    want = [float(jt.train_step(b)) for b in batches]
    got = [float(pt.train_step(b)) for b in batches]
    rel = _rel(got, want)
    assert np.all(rel[:4] < 5e-6), rel[:4]
    assert np.all(rel < 2e-4), rel
    assert pt.step == int(jt.state.step) == 12


@pytest.mark.parametrize("fused_bn,loss_rtol", [("twopass", 5e-5), (None, 5e-4)])
def test_resnet_step_matches_jax_with_every_batchnorm(fused_bn, loss_rtol):
    """One step of the ResNet; with the one-pass variance the float32
    cancellation in small late-stage batches (16 values a channel at layer4)
    moves the loss by up to 7e-5 between the two backends (measured on three
    seeds; 1e-5 two-pass), hence its own tolerance."""
    B, T, N, H, W = 1, 4, 4, 16, 16
    (batch,) = _batches(1, (B, T, N, H, W), seed=1)
    jt = _jax_trainer((T, N, H, W), model=1, batch_size=B, fused_bn=fused_bn)
    pt = _port_trainer((T, N, H, W), jt.variables(), model=1, batch_size=B, fused_bn=fused_bn)
    want_loss = float(jt.train_step(batch))
    got_loss = float(pt.train_step(batch))
    np.testing.assert_allclose(got_loss, want_loss, rtol=loss_rtol)
    want = export_state_dict(_np_tree(jt.variables()))
    got = {k: v.numpy() for k, v in pt.model.state_dict().items()}
    checked = 0
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            scale = float(np.max(np.abs(want[k]))) or 1.0
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3 * scale, err_msg=k)
            checked += 1
    assert checked == 26  # 13 BatchNorms x (mean, var)
    assert all(int(v) == 1 for k, v in pt.model.state_dict().items()
               if k.endswith("num_batches_tracked"))


def test_fit_matches_jax_and_resident_equals_host():
    """Two epochs of 45 windows at batch 8 (a partial batch of 5 each
    epoch): the port's history against JAX fit's from the same init; the
    port's resident and host paths give the same losses."""
    ds = _dataset()
    assert len(ds) == 45
    jt = _jax_trainer(ds[0].shape, model=0, batch_size=8, epochs=2)
    host = _port_trainer(ds[0].shape, jt.variables(), model=0, batch_size=8, epochs=2,
                         device_resident=False)
    want = jt.fit(JaxRGWindows(_radargram(), length=6, dim=(16, 16), overlap=(8, 0)),
                  log=lambda s: None)
    resident = _port_trainer_like(host, device_resident=True)
    lines = []
    got = resident.fit(ds, log=lines.append)
    assert _rel(got, want).max() < 2e-4, (got, want)
    assert host.fit(ds, log=lambda s: None) == got
    assert resident._resident_rg[0] is ds.rg
    assert [ln.split(" Time:")[0] for ln in lines] == [
        f"Epoch: {e} Loss: {loss}" for e, loss in enumerate(got)]
    assert resident.step == 2 * 6
