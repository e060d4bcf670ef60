"""The port's CRW trainer on its own paths (CPU, float32 unless stated):
the epoch order across fit() calls, the resident path's refusal, remat,
bfloat16, checkpoints and resume, the exported encoder in both packages,
the device refusal, and the BatchNorm variants' modules. Paths that do
the same arithmetic are compared exactly (remat and no remat, a resumed
run and an uninterrupted one); bfloat16 against float32: the step-1 loss
within relative 2e-2. tests/test_torch_train.py holds the trainer to the
JAX one.
"""

import jax
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.models import load_torch_checkpoint as jax_load_torch_checkpoint
from radar_sounder_crw_tpu.models.torch_import import export_state_dict
from radar_sounder_crw_tpu_torch.models import create_model, load_torch_checkpoint
from radar_sounder_crw_tpu_torch.train import (
    CheckpointManager,
    CRWTrainConfig,
    CRWTrainer,
    UNetTrainConfig,
    UNetTrainer,
    save_encoder_torch,
)
from radar_sounder_crw_tpu_torch.data import RGWindows, synthetic_radargram
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from test_torch_train import LR, TAU, _batches, _dataset, _port_trainer_like


def _small_dataset():
    """13 windows of T = 6 frames, N = 4 patches: trainer paths at little cost."""
    rg, _ = synthetic_radargram(H=40, W=300, seed=7)
    return RGWindows(rg, length=6, dim=(16, 16), overlap=(8, 0))


def test_epoch_order_advances_across_fit_calls():
    ds = _small_dataset()
    one = CRWTrainer(CRWTrainConfig(model=0, batch_size=4, epochs=2), device="cpu")
    one.init_state(ds[0].shape)
    two = _port_trainer_like(one, epochs=1)
    history = one.fit(ds, log=lambda s: None)
    assert two.fit(ds, log=lambda s: None) + two.fit(ds, log=lambda s: None) == history
    assert two._epoch_idx == 2


def test_device_resident_true_refuses_a_plain_dataset():
    class Plain:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return 4

        def __getitem__(self, i):
            return self.inner[i]

    ds = _dataset()
    trainer = CRWTrainer(CRWTrainConfig(model=0, device_resident=True), device="cpu")
    with pytest.raises(ValueError, match="device_resident=True"):
        trainer.fit(Plain(ds), log=lambda s: None)


def test_remat_equals_no_remat_and_updates_statistics_once():
    B, T, N, H, W = 2, 4, 4, 16, 16
    batches = _batches(3, (B, T, N, H, W), seed=2)
    base = CRWTrainer(CRWTrainConfig(model=1, lr=LR, tau=TAU, batch_size=B), device="cpu")
    base.init_state((T, N, H, W))
    remat = _port_trainer_like(base, remat=True)
    want = [float(base.train_step(b)) for b in batches]
    got = [float(remat.train_step(b)) for b in batches]
    assert got == want
    want_sd, got_sd = base.model.state_dict(), remat.model.state_dict()
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    assert all(int(v) == 3 for k, v in got_sd.items() if k.endswith("num_batches_tracked"))


def test_bfloat16_step_is_close_to_float32():
    B, T, N, H, W = 2, 5, 6, 16, 16
    (batch,) = _batches(1, (B, T, N, H, W), seed=3)
    f32 = CRWTrainer(CRWTrainConfig(model=1, lr=LR, tau=TAU, batch_size=B), device="cpu")
    f32.init_state((T, N, H, W))
    bf16 = _port_trainer_like(f32, dtype=torch.bfloat16)
    want, got = float(f32.train_step(batch)), float(bf16.train_step(batch))
    assert np.isfinite(got) and abs(got - want) / abs(want) < 2e-2, (got, want)
    assert all(p.dtype == torch.float32 for p in bf16.model.parameters())
    x = torch.tensor(batch[0, 0][:, None])
    with torch.no_grad():
        assert bf16.model(x).dtype == torch.float32


def test_checkpoint_resume_continues_the_schedule(tmp_path):
    ds = _small_dataset()
    full = CRWTrainer(CRWTrainConfig(model=1, lr=LR, tau=TAU, batch_size=8, epochs=2),
                      device="cpu")
    full.init_state(ds[0].shape)
    first = _port_trainer_like(full, epochs=1)
    want = full.fit(ds, log=lambda s: None)
    got = first.fit(ds, log=lambda s: None)
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for step in (0, 1, first.step):
        mgr.save(step, first.state_dict())
    assert mgr.steps() == [1, first.step] and mgr.latest_step() == first.step

    resumed = _port_trainer_like(first)
    resumed.load_state_dict(mgr.restore())
    assert resumed.step == first.step == 2
    got += resumed.fit(ds, log=lambda s: None)
    assert got == want
    assert resumed.step == full.step == 4
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_exported_encoder_loads_in_both_packages(tmp_path):
    ds = _small_dataset()
    trainer = CRWTrainer(CRWTrainConfig(model=1, lr=LR, tau=TAU, batch_size=4), device="cpu")
    trainer.init_state(ds[0].shape)
    trainer.train_step(np.stack([ds[0], ds[1]]))
    path = tmp_path / "models" / "enc.pt"
    save_encoder_torch(trainer.model, path)
    sd = trainer.variables()

    port = load_torch_checkpoint(path, create_model(1, False, device="cpu", seed=5))
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k
    back = export_state_dict(jax.tree.map(np.asarray, jax_load_torch_checkpoint(str(path))))
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)


@pytest.mark.parametrize("fused_bn", [True, "fused", "lean"])
def test_tpu_batchnorm_variants_are_refused(fused_bn):
    """The JAX package's hand-scheduled BatchNorms, refused before they were
    ported (models/fused_bn.py), now build every BatchNorm of the trainer's
    ResNet; a value the JAX `make_norm` does not know is refused."""
    from radar_sounder_crw_tpu_torch.models import BatchNorm, FusedBatchNorm, LeanBatchNorm

    trainer = CRWTrainer(CRWTrainConfig(model=1, fused_bn=fused_bn), device="cpu")
    trainer.init_state((4, 4, 16, 16))
    kind = LeanBatchNorm if fused_bn == "lean" else FusedBatchNorm
    bns = [m for m in trainer.model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 13 and all(type(m) is kind for m in bns)
    with pytest.raises(ValueError, match="unknown BatchNorm implementation"):
        CRWTrainer(CRWTrainConfig(model=1, fused_bn=f"{fused_bn}x"), device="cpu").init_state(
            (4, 4, 16, 16))


def test_trainers_default_to_cuda_and_refuse_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CRWTrainer(CRWTrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNetTrainer(UNetTrainConfig())


def test_profiling_helpers_on_the_cpu(tmp_path):
    """profile_trace writes a Chrome trace, the port's spans in it, and
    does nothing without a directory."""
    from radar_sounder_crw_tpu_torch.utils import profile_trace, span

    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "trace")):
        with span("crw.encode"):
            torch.ones(8).sum()
    assert '"crw.encode"' in (tmp_path / "trace" / "trace.json").read_text()


def test_make_window_gather_binds_the_geometry():
    from radar_sounder_crw_tpu_torch.data import gather_windows, make_window_gather

    ds = _dataset()
    rg = torch.as_tensor(ds.rg)
    gather = make_window_gather(ds.geo)
    ids = np.array([0, 7, len(ds) - 1])
    assert torch.equal(gather(rg, ids), gather_windows(rg, ids, ds.geo))
    np.testing.assert_array_equal(gather(rg, ids)[1].numpy(), ds[7])
    short = make_window_gather(ds.geo, length=3)(rg, ids)
    assert short.shape[1] == 3
