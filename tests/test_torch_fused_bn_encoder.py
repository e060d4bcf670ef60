"""The ResNet encoder with every BatchNorm the JAX package's `make_norm`
accepts (None, 'twopass', True, 'fused', 'lean'), the port against the JAX
one on the CPU, by the float64 criterion of tests/test_fused_bn.py
(`test_resnet_encoder_fused_flag_equivalence`).

Both encoders hold the same weights (the JAX init through
`state_dict_from_jax`, loaded strictly) and take the gradient of
sum(y * y) in train mode on one numpy batch. Through ten convolutions and
BatchNorms two float32 roundings of the same function drift apart by up to
1e-2 on ill-conditioned leaves while both stay 1e-1 from the truth, so each
gradient leaf is held to float64 (the JAX encoder, flax's BatchNorm, at
float64): the port's relative L2 error within 1.5 times the JAX float32
encoder's of the same `fused_bn` (JAX's own factor), + 1e-6. Measured, the
port's errors are at most 0.14 of JAX's. The forward at the mutual
rounding scale: relative L2 within 1e-4 of the JAX output.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.models import ResNetEncoder as JaxResNetEncoder
from radar_sounder_crw_tpu.models.torch_import import export_state_dict
from radar_sounder_crw_tpu_torch.models import ResNetEncoder, state_dict_from_jax
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)


def _rel_l2(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@functools.lru_cache(maxsize=None)
def _setup():
    """(input NHWC, the JAX variables, float64 gradients by port name)."""
    x = np.random.default_rng(4).standard_normal((4, 16, 16, 1)).astype(np.float32)
    variables = JaxResNetEncoder(pos_embed=False, fused_bn=False, s2d_stem=False).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    jax.config.update("jax_enable_x64", True)
    try:
        enc64 = JaxResNetEncoder(pos_embed=False, fused_bn=False, s2d_stem=False,
                                 dtype=jnp.float64)
        g64 = _jax_grads(enc64, variables, x, jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    return x, variables, g64


def _jax_grads(enc, variables, x, dtype):
    params = jax.tree.map(lambda a: a.astype(dtype), variables["params"])
    stats = jax.tree.map(lambda a: a.astype(dtype), variables["batch_stats"])

    def loss(p):
        y, _ = enc.apply({"params": p, "batch_stats": stats}, jnp.asarray(x, dtype), train=True,
                         mutable=["batch_stats"])
        return jnp.sum(y * y)

    grads = jax.jit(jax.grad(loss))(params)
    return export_state_dict({"params": jax.tree.map(np.asarray, grads)})


@pytest.mark.parametrize("fused_bn", [None, "twopass", True, "fused", "lean"])
def test_encoder_gradients_against_float64(fused_bn):
    x, variables, g64 = _setup()
    jax_enc = JaxResNetEncoder(pos_embed=False, fused_bn=fused_bn, s2d_stem=False)
    y_jax, _ = jax_enc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    g_jax = _jax_grads(jax_enc, variables, x, jnp.float32)

    port = ResNetEncoder(pos_embed=False, fused_bn=fused_bn)
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    port.train()
    y = port(torch.as_tensor(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))))
    assert _rel_l2(y.detach().numpy(), y_jax) < 1e-4
    (y * y).sum().backward()
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(grads) == set(g64)
    for name, truth in g64.items():
        err_port, err_jax = _rel_l2(grads[name], truth), _rel_l2(g_jax[name], truth)
        # fc0.bias: its true gradient is ~0 (a bias before a train-mode
        # BatchNorm cancels against the batch mean), both errors are noise
        assert err_port <= 1.5 * err_jax + 1e-6, f"{name}: {err_port:.2e} vs JAX {err_jax:.2e}"
