"""The ResNet encoder's eval forward with each BatchNorm folded into the
convolution before it (models/resnet.py `fold_conv_bn`, models/encoders.py
`ResNetEncoder._eval_fold`), on the CPU.

The folded forward is held to a float64 forward written here (convolution,
then eval `F.batch_norm`) within 5e-6 on L2-normalised embeddings; the fold
is built once and again whenever a source tensor changes; the train-mode,
`bn_train_mode`, bfloat16, gradient and CNN forwards keep the plain path;
the state dict and strict loading of JAX-bridged weights are unchanged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radar_sounder_crw_tpu.models import create_model as jax_create_model
from radar_sounder_crw_tpu_torch.infer.propagate import encode_sequence
from radar_sounder_crw_tpu_torch.models import create_model, encoders, state_dict_from_jax

ATOL = 5e-6


def calibrated(pos_embed=False, seed=0, patches=512):
    """A ResNet encoder in eval mode whose running statistics are those of
    a batch of patches (momentum 1: the batch's own statistics)."""
    model = create_model(1, pos_embed, device="cpu", seed=seed)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    g = torch.Generator().manual_seed(seed + 1)
    x = 0.5 + torch.randn((patches, 2 if pos_embed else 1, 16, 16), generator=g)
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    for m in bns:
        m.momentum = 0.1
    return model.eval()


def reference64(model, x):
    """The encoder's eval forward in float64: every convolution, then eval
    BatchNorm with the running statistics; L2-normalised embeddings."""

    def conv_bn(conv, bn, h, stride, padding):
        bias = None if conv.bias is None else conv.bias.double()
        h = F.conv2d(h, conv.weight.double(), bias, stride, padding)
        return F.batch_norm(h, bn.running_mean.double(), bn.running_var.double(),
                            bn.weight.double(), bn.bias.double(), False, 0.0, bn.eps)

    with torch.no_grad():
        h = F.relu(conv_bn(model.fc0, model.bn0, x.double(), 1, 1))
        core = model.model
        h = F.max_pool2d(F.relu(conv_bn(core.conv1, core.bn1, h, 2, 3)), 3, 2, 1)
        for stage in range(4):
            block = getattr(core, f"layer{stage + 1}")[0]
            stride = 1 if stage == 0 else 2
            identity = h if block.downsample is None else conv_bn(
                block.downsample[0], block.downsample[1], h, stride, 0)
            y = F.relu(conv_bn(block.conv1, block.bn1, h, stride, 1))
            h = F.relu(conv_bn(block.conv2, block.bn2, y, 1, 1) + identity)
        out = F.linear(h.mean(dim=(2, 3)), core.fc.weight.double(), core.fc.bias.double())
    return out / out.norm(dim=-1, keepdim=True)


def embed(model, x):
    with torch.no_grad():
        out = model(x)
    return out / out.norm(dim=-1, keepdim=True)


def patches(n, pos_embed=False, seed=7):
    g = torch.Generator().manual_seed(seed)
    return 0.5 + torch.randn((n, 2 if pos_embed else 1, 16, 16), generator=g)


@pytest.mark.parametrize("pos_embed", [False, True])
def test_folded_forward_against_float64(pos_embed):
    model = calibrated(pos_embed)
    x = patches(256, pos_embed)
    folded = encoders.bn_fold["folded"]
    got = embed(model, x)
    assert encoders.bn_fold["folded"] == folded + 1
    err = (got.double() - reference64(model, x)).abs().max().item()
    assert err <= ATOL, err


def _load_state_dict(model):
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["model.layer3.0.conv1.weight"].mul_(1.5)
    model.load_state_dict(sd, strict=True)


def _in_place_parameter(model):
    with torch.no_grad():
        model.model.layer2[0].bn2.weight.mul_(0.5)


def _running_statistic(model):
    with torch.no_grad():
        model.model.layer4[0].bn1.running_var.mul_(3.0)


def _to(model):
    model.double().float()


def _train_round_trip(model):
    # a change no _version sees, as a CUDA graph's replayed train steps make
    model.model.conv1.weight.data.mul_(0.5)
    model.train().eval()


@pytest.mark.parametrize("change", [_load_state_dict, _in_place_parameter, _running_statistic,
                                    _to, _train_round_trip])
def test_fold_is_built_once_and_again_after_a_change(change):
    model = calibrated()
    x = patches(64)
    builds = encoders.bn_fold["builds"]
    embed(model, x)
    assert encoders.bn_fold["builds"] == builds + 1
    for _ in range(3):
        embed(model, x)
    assert encoders.bn_fold["builds"] == builds + 1
    change(model)
    got = embed(model, x)
    assert encoders.bn_fold["builds"] == builds + 2
    assert (got.double() - reference64(model, x)).abs().max().item() <= ATOL


def _train_mode(model, x):
    model.train()
    with torch.no_grad():
        model(x)


def _bn_train_mode(model, x):
    encode_sequence(model, x.reshape(4, -1, 16, 16), False, True)


def _bfloat16(model, x):
    model.compute_dtype = torch.bfloat16
    with torch.no_grad():
        model(x)


def _gradient(model, x):
    model(x).sum().backward()
    assert model.model.layer1[0].conv1.weight.grad.abs().sum() > 0
    assert model.bn0.weight.grad.abs().sum() > 0


def _cnn(model, x):
    with torch.no_grad():
        create_model(0, False, device="cpu")(x)


@pytest.mark.parametrize("forward", [_train_mode, _bn_train_mode, _bfloat16, _gradient, _cnn])
def test_other_forwards_take_the_plain_path(forward):
    model = calibrated()
    x = patches(32)
    before = dict(encoders.bn_fold)
    forward(model, x)
    assert encoders.bn_fold["folded"] == before["folded"]
    assert encoders.bn_fold["plain"] == before["plain"] + 1
    assert encoders.bn_fold["builds"] == before["builds"]


def test_bn_train_mode_output_unchanged_by_an_earlier_fold():
    model = calibrated()
    seq = patches(32).reshape(4, 8, 16, 16)
    want = encode_sequence(model, seq, False, True)
    encode_sequence(model, seq, False, False)  # builds the fold
    torch.testing.assert_close(encode_sequence(model, seq, False, True), want, rtol=0, atol=0)


def test_state_dict_unchanged_and_jax_weights_load_strictly():
    fresh = create_model(1, False, device="cpu")
    model = calibrated()
    embed(model, patches(8))
    assert list(model.state_dict()) == list(fresh.state_dict())
    assert len(model.state_dict()) == 81
    # the flax variables' tree (shapes only, nothing compiled), filled from a seed
    shapes = jax.eval_shape(functools.partial(jax_create_model(1, False).init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1])) if name == "kernel" else 0.1
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    builds = encoders.bn_fold["builds"]
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = patches(16)
    got = embed(model, x)
    assert encoders.bn_fold["builds"] == builds + 1
    assert (got.double() - reference64(model, x)).abs().max().item() <= ATOL
