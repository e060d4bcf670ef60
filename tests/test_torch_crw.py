"""The port's CRW loss (radar_sounder_crw_tpu_torch/ops/crw.py) vs the JAX
one (radar_sounder_crw_tpu/ops/crw.py) on shared embeddings (CPU, float32).

Values and gradients with respect to the raw embeddings, for the O(T)
prefix walk, the unrolled left fold, `per_item`, `only_a`, T = 2 and
all-zero rows. Tolerance: rtol 1e-5 / atol 1e-6 on values and affinities,
rtol 1e-4 with atol 1e-6 x max|grad| on gradients (float32 on both sides,
different summation and association orders; tau = 0.05 scales the
affinities by 20, and the chains multiply up to 2T - 3 softmaxes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.ops import crw as jax_crw
from radar_sounder_crw_tpu_torch.ops import crw
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

TAU = 0.05
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


def _emb(shape, seed, zero_rows=()):
    emb = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    for idx in zero_rows:
        emb[idx] = 0.0
    return emb


def _jax(emb, **kw):
    def f(e):
        out = jax_crw.crw_loss(e, TAU, **kw)
        if kw.get("only_a"):
            return jnp.sum(out * jnp.cos(out)), out
        loss, A = out
        return jnp.sum(loss * jnp.arange(1, loss.size + 1).reshape(loss.shape)), out

    (_, out), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(emb))
    return jax.tree.map(np.asarray, out), np.asarray(grad)


def _port(emb, **kw):
    e = torch.tensor(emb, requires_grad=True)
    out = crw.crw_loss(e, TAU, **kw)
    if kw.get("only_a"):
        (out * torch.cos(out)).sum().backward()
        return out.detach().numpy(), e.grad.numpy()
    loss, A = out
    w = torch.arange(1, loss.numel() + 1, dtype=torch.float32).reshape(loss.shape)
    (loss * w).sum().backward()
    return (loss.detach().numpy(), A.detach().numpy()), e.grad.numpy()


def _close_grad(got, want):
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=1e-6 * scale)


@pytest.mark.parametrize("shape", [(2, 6, 5, 8), (1, 9, 12, 16), (3, 3, 4, 4)])
@pytest.mark.parametrize("variant", ["prefix", "unrolled", "per_item"])
def test_crw_loss_and_grad_match_jax(shape, variant):
    kw = {"unrolled": variant == "unrolled", "per_item": variant == "per_item"}
    emb = _emb(shape, seed=sum(shape))
    (want_loss, want_A), want_grad = _jax(emb, **kw)
    (got_loss, got_A), got_grad = _port(emb, **kw)
    assert got_loss.shape == want_loss.shape
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_A, want_A, rtol=RTOL, atol=1e-5)
    _close_grad(got_grad, want_grad)


def test_prefix_walk_equals_unrolled_and_per_item_mean():
    emb = _emb((2, 7, 6, 8), seed=3)
    e = torch.tensor(emb)
    prefix, _ = crw.crw_loss(e, TAU)
    unrolled, _ = crw.crw_loss(e, TAU, unrolled=True)
    per, _ = crw.crw_loss(e, TAU, per_item=True)
    np.testing.assert_allclose(prefix.item(), unrolled.item(), rtol=1e-5)
    np.testing.assert_allclose(per.mean().item(), prefix.item(), rtol=1e-6)


def test_only_a_returns_the_affinities_alone():
    emb = _emb((2, 5, 4, 8), seed=4)
    want, want_grad = _jax(emb, only_a=True)
    got, got_grad = _port(emb, only_a=True)
    assert got.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    _close_grad(got_grad, want_grad)


@pytest.mark.parametrize("per_item", [False, True])
def test_two_frames_give_zero_with_a_defined_gradient(per_item):
    emb = _emb((2, 2, 4, 8), seed=5)
    (want_loss, _), want_grad = _jax(emb, per_item=per_item)
    (got_loss, _), got_grad = _port(emb, per_item=per_item)
    assert got_loss.shape == want_loss.shape
    assert np.all(got_loss == 0.0) and np.all(want_loss == 0.0)
    np.testing.assert_array_equal(got_grad, np.zeros_like(got_grad))
    np.testing.assert_array_equal(want_grad, np.zeros_like(want_grad))


def test_zero_rows_keep_the_gradient_finite():
    """A zero-padded placeholder patch (all-zero embedding row) normalizes to
    zero and back-propagates a finite gradient, as on the JAX side."""
    emb = _emb((2, 5, 4, 8), seed=6, zero_rows=[(0, 1, 2), (1, 3, 0), (1, 3, 3)])
    (want_loss, _), want_grad = _jax(emb, per_item=True)
    (got_loss, _), got_grad = _port(emb, per_item=True)
    assert np.isfinite(got_grad).all() and np.isfinite(want_grad).all()
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL, atol=ATOL)
    _close_grad(got_grad, want_grad)


def test_loss_is_float32_under_bfloat16_autocast():
    """Embeddings handed over inside a bfloat16 autocast region still give
    float32 affinities and the float32 loss."""
    emb = torch.tensor(_emb((2, 5, 4, 8), seed=7))
    want, _ = crw.crw_loss(emb, TAU)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got, A = crw.crw_loss(emb, TAU)
    assert got.dtype == torch.float32 and A.dtype == torch.float32
    assert got.item() == want.item()
