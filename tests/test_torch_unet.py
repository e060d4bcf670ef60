"""The port's UNet baseline (radar_sounder_crw_tpu_torch/models/unet.py,
train/unet_trainer.py, utils/resize.py) vs the JAX package's (CPU, float32).

JAX variables cross to the port through `state_dict_from_jax` and load with
strict=True (bilinear and transposed-conv upsampling). Tolerances:
`resize_bilinear_align_corners` rtol 1e-5 / atol 1e-6 (tests/test_resize.py's);
forward logits atol 1e-4 x their largest magnitude and running statistics
rtol 1e-4 (float32, different conv summation orders; the one-pass batch
variance of flax on both sides); the K = 10 trajectory within the envelope
of tests/test_reference_train_trajectory.py's UNet test (relative 2e-6 at
step 1, 5e-4 throughout) with >= 99.5 % equal eval maps; a two-epoch `fit`
with a partial last batch within that envelope per epoch; one step on a
partial batch: its loss within rtol 2e-6, the running statistics within
rtol 1e-4 (atol 1e-5 x the stat's largest magnitude). The port's resident and
host paths are compared exactly (same arithmetic on the CPU); unfold_strips
and train_test_split byte for byte.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.models.torch_import import export_state_dict
from radar_sounder_crw_tpu.models.unet import UNet as JaxUNet
from radar_sounder_crw_tpu.parallel import make_mesh
from radar_sounder_crw_tpu.train import unet_trainer as jax_unet_trainer
from radar_sounder_crw_tpu.utils.resize import (
    resize_bilinear_align_corners as jax_resize_bilinear,
)
from radar_sounder_crw_tpu_torch.models import UNet, create_unet, state_dict_from_jax
from radar_sounder_crw_tpu_torch.train import unet_trainer
from radar_sounder_crw_tpu_torch.utils import resize_bilinear_align_corners
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

LR = 1e-3


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("in_hw,out_hw", [((8, 8), (16, 16)), ((7, 9), (14, 18)), ((5, 5), (3, 7))])
def test_bilinear_align_corners_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(1).standard_normal((2, 3, *in_hw)).astype(np.float32)
    want = np.asarray(jax_resize_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)), out_hw))
    got = resize_bilinear_align_corners(torch.tensor(x), out_hw).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_init(bilinear, n_classes, hw, seed):
    model = JaxUNet(n_channels=1, n_classes=n_classes, bilinear=bilinear)
    init = jax.jit(functools.partial(model.init, train=False))
    return model, init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 1)))


def _jax_unet(bilinear, n_classes=4, hw=(30, 18), seed=0):
    model, variables = _jax_init(bilinear, n_classes, hw, seed)
    variables = _np_tree(variables)
    rng = np.random.default_rng(seed)
    for node in jax.tree_util.tree_leaves(
            variables["batch_stats"], is_leaf=lambda n: isinstance(n, dict) and "mean" in n):
        node["mean"] = (0.1 * rng.standard_normal(node["mean"].shape)).astype(np.float32)
        node["var"] = rng.uniform(0.5, 2.0, node["var"].shape).astype(np.float32)
    return model, variables


@pytest.mark.parametrize("bilinear,train", [(True, False), (True, True), (False, False)])
def test_forward_matches_jax(bilinear, train):
    """Odd sizes (30 x 18 -> 15 x 9 -> 7 x 4 -> 3 x 2) exercise the
    asymmetric skip padding; train mode the batch statistics and their
    update."""
    jmodel, variables = _jax_unet(bilinear)
    x = np.random.default_rng(2).standard_normal((3, 30, 18, 1)).astype(np.float32)
    tmodel = UNet(1, 4, bilinear=bilinear)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmodel.train(train)
    apply = jax.jit(functools.partial(jmodel.apply, train=train,
                                      mutable=["batch_stats"] if train else False))
    if train:
        want, upd = apply(variables, jnp.asarray(x))
    else:
        want = apply(variables, jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = tmodel(torch.tensor(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.max(np.abs(want)))
    if train:
        new = export_state_dict({"batch_stats": _np_tree(upd["batch_stats"])})
        sd = tmodel.state_dict()
        assert len(new) == 2 * 14  # 7 DoubleConvs x 2 BatchNorms x (mean, var)
        for k, v in new.items():
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_state_dict_names_are_the_reference_ones():
    sd = create_unet(1, 5, device="cpu").state_dict()
    for key in ("inc.double_conv.0.weight", "inc.double_conv.1.running_var",
                "down1.maxpool_conv.1.double_conv.3.weight", "up1.conv.double_conv.4.bias",
                "outc.conv.weight", "outc.conv.bias"):
        assert key in sd, key
    assert "inc.double_conv.0.bias" not in sd  # convolutions without bias
    assert "up1.up.weight" in UNet(1, 5, bilinear=False).state_dict()


def _unet_batches(B=4, H=32, W=16, C=4, K=10, seed=3):
    """tests/test_reference_train_trajectory.py's UNet schedule."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((C,)).astype(np.float32) * 2.0
    bands = np.linspace(0, C, H, endpoint=False).astype(np.int64)

    def make_batch():
        y = np.broadcast_to(bands[None, :, None], (B, H, W))
        x = protos[y] + 0.5 * rng.standard_normal((B, H, W))
        return x[..., None].astype(np.float32), np.eye(C, dtype=np.float32)[y]

    return [make_batch() for _ in range(K)], make_batch()


@functools.lru_cache(maxsize=None)
def _jax_trainer():
    """One JAX trainer for the module (its jitted steps compile once per
    batch shape), host batches, two epochs per fit(), and its initial state."""
    cfg = jax_unet_trainer.UNetTrainConfig(batch_size=4, epochs=2, lr=LR, n_classes=4,
                                           device_resident=False)
    jt = jax_unet_trainer.UNetTrainer(cfg, mesh=make_mesh(jax.devices()[:1]))
    jt.init_state((4, 32, 16, 1))
    return jt, _np_tree(jt.state)  # a host copy: the steps donate their input state


def _trainers(**kw):
    """(the JAX trainer reset to its initial state, a port trainer from the
    same init; `kw` sets the port's config)."""
    jt, state0 = _jax_trainer()
    jt.state, jt._epoch_idx = jax.tree.map(jnp.array, state0), 0
    cfg = {"batch_size": 4, "epochs": 2, "lr": LR, "n_classes": 4, **kw}
    pt = unet_trainer.UNetTrainer(unet_trainer.UNetTrainConfig(**cfg), device="cpu")
    pt.init_state((4, 32, 16, 1))
    variables = _np_tree({"params": state0.params, "batch_stats": state0.batch_stats})
    pt.model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jt, pt


def _port_step(pt, x, y):
    return float(pt.train_step(torch.tensor(x.transpose(0, 3, 1, 2)), torch.tensor(y)))


def test_trajectory_and_eval_maps_match_jax():
    batches, (x_te, y_te) = _unet_batches()
    jt, pt = _trainers()
    want, got = [], []
    w = jnp.ones(4, jnp.float32)
    for x, y in batches:
        jt.state, loss = jt._step(jt.state, jnp.asarray(x), jnp.asarray(y), w)
        want.append(float(loss))
        got.append(_port_step(pt, x, y))
    rel = np.abs(np.asarray(got) - want) / np.abs(want)
    assert rel[0] < 2e-6, rel
    assert np.all(rel < 5e-4), rel
    agree = (pt.predict(x_te) == jt.predict(x_te)).mean()
    assert agree >= 0.995, agree


def test_quirk_flag_changes_the_loss():
    x, y = _unet_batches(K=1)[0][0]
    losses = {}
    for quirk in (True, False):
        pt = unet_trainer.UNetTrainer(unet_trainer.UNetTrainConfig(
            n_classes=4, quirk_double_softmax=quirk), device="cpu")
        pt.init_state(x.shape)
        losses[quirk] = pt.loss(pt.model.train()(torch.tensor(x.transpose(0, 3, 1, 2))),
                                torch.tensor(y), torch.ones(4)).item()
    # probabilities as logits: a pixel's CE log(sum_j e^p_j) - p_true lies in
    # [log(M - 1 + e) - 1, log(M - 1 + e)], whatever the logits
    assert losses[True] != losses[False]
    assert np.log(3 + np.e) - 1 <= losses[True] <= np.log(3 + np.e)


def _strips(S=10, H=32, W=16, C=4, seed=5):
    """A banded radargram like the trajectory's batches, S strips wide plus
    a remainder that unfold_strips drops."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((C,)).astype(np.float32) * 2.0
    seg = np.broadcast_to(np.linspace(0, C, H, endpoint=False).astype(np.int32)[:, None],
                          (H, S * W + 7)).copy()
    rg = (protos[seg] + 0.5 * rng.standard_normal(seg.shape)).astype(np.float32)
    return rg, seg


def test_unfold_strips_and_split_are_equal_byte_for_byte():
    rg, seg = _strips()
    got = unet_trainer.unfold_strips(rg, seg, 16, 4)
    want = jax_unet_trainer.unfold_strips(rg, seg, 16, 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    for n, split, seed in ((10, 0.9, 11), (128, 0.9, 11), (7, 0.5, 3)):
        for g, w in zip(unet_trainer.train_test_split(n, split, seed),
                        jax_unet_trainer.train_test_split(n, split, seed)):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_fit_with_a_partial_batch_matches_jax_and_resident_equals_host():
    """10 strips at batch 4 (4, 4, 2): the partial batch normalizes with its
    own two strips' statistics on both sides; JAX fit's history and running
    statistics against the port's, resident against host exactly."""
    rg, seg = _strips()
    x, y = unet_trainer.unfold_strips(rg, seg, 16, 4)
    jt, pt = _trainers()
    _, host = _trainers(device_resident=False)
    want = jt.fit(x, y, log=lambda s: None)
    lines = []
    got = pt.fit(x, y, log=lines.append)
    assert pt._resident_data is not None and host.fit(x, y, log=lambda s: None) == got
    rel = np.abs(np.asarray(got) - want) / np.abs(want)
    assert np.all(rel < 5e-4), (got, want)
    assert lines[0].startswith(f"Epoch: 1 Loss: {got[0]} Time: ")
    assert pt.step == 6


def test_partial_batch_step_matches_jax():
    """One step on a batch of 2 strips from the JAX init: the loss and all
    14 BatchNorms' running statistics, from that batch's own statistics."""
    rg, seg = _strips(S=2)
    x, y = unet_trainer.unfold_strips(rg, seg, 16, 4)
    jt, pt = _trainers()
    jt.state, loss = jt._step(jt.state, jnp.asarray(x), jnp.asarray(y), jnp.ones(2))
    np.testing.assert_allclose(_port_step(pt, x, y), float(loss), rtol=2e-6)
    stats = export_state_dict({"batch_stats": _np_tree(jt.state.batch_stats)})
    assert len(stats) == 28
    sd = pt.model.state_dict()
    for k, v in stats.items():
        scale = float(np.max(np.abs(v)))
        np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_device_resident_true_refuses_soft_labels():
    rg, seg = _strips(S=4)
    x, y = unet_trainer.unfold_strips(rg, seg, 16, 4)
    y = y * 0.5 + 0.125
    tr = unet_trainer.UNetTrainer(unet_trainer.UNetTrainConfig(
        batch_size=4, epochs=1, n_classes=4, device_resident=True), device="cpu")
    with pytest.raises(ValueError, match="one-hot"):
        tr.fit(x, y, log=lambda s: None)


def test_bfloat16_forward_is_close_and_float32_out():
    model = create_unet(1, 4, device="cpu", seed=1)
    bf16 = create_unet(1, 4, dtype=torch.bfloat16, device="cpu", seed=1)
    x = torch.tensor(np.random.default_rng(6).standard_normal((2, 1, 32, 16)),
                     dtype=torch.float32)
    with torch.no_grad():
        want, got = model(x), bf16(x)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 0.05 * want.abs().max()
