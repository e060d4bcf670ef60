"""PyTorch port label propagation vs the JAX package (CPU).

The port's plain path (kernel='torch', the CUDA kernel's twin) is held
against JAX `propagate_labels(kernel='xla')` on the same numpy-seeded
embeddings: soft labels to rtol 1e-4 / atol 1e-6 (CPU matmuls sum in other
orders on the two sides), argmax maps exactly equal. The single step is held
against the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.ops.labelprop import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu.ops.labelprop import _slot_validity as jax_slot_validity
from radar_sounder_crw_tpu.ops.labelprop import propagate_labels as jax_propagate
from radar_sounder_crw_tpu.ops.labelprop import radius_mask as jax_radius_mask
from radar_sounder_crw_tpu.ops.labelprop_pallas import prop_step_pallas
from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
from radar_sounder_crw_tpu_torch.ops.labelprop import (
    NEG_INVALID,
    LabelPropConfig,
    _prop_step,
    _slot_validity,
    propagate_labels,
    radius_mask,
)

RTOL, ATOL = 1e-4, 1e-6


def make_inputs(T, N, C, M, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((T, N, C)).astype(np.float32)
    if ties:  # one decimal: many exactly equal affinities
        emb = np.round(emb, 1).astype(np.float32)
    else:
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    onehot = np.eye(M, dtype=np.float32)[rng.integers(0, M, N)]
    return emb, onehot


@pytest.mark.parametrize(
    "T,N,C,M,ctx,radius,knn,long_mem,ties",
    [
        # the shapes of tests/test_labelprop_pallas.py::test_fused_kernel_matches_xla
        (8, 16, 32, 4, 5, 5, 3, (0,), False),  # ring wraps (cxt < T)
        (6, 16, 32, 4, 10, 4, 3, (0,), False),  # no wrap
        (5, 12, 16, 5, 3, 100, 6, (0,), False),  # radius covers everything
        (6, 16, 32, 4, 9, 5, 4, (0,), False),
        (4, 190, 32, 6, 6, 60, 5, (0,), False),  # MC3 grid, N = 190
        (4, 128, 16, 3, 3, 50, 4, (0,), False),
        (5, 5, 16, 3, 3, 2, 2, (0,), False),  # tiny N
        (14, 20, 8, 5, 6, 3, 4, (0, 2), False),  # multi-frame long_mem pins
        (5, 9, 8, 3, 3, 4, 30, (0,), False),  # knn > candidate count
        (9, 12, 16, 4, 5, 4, 3, (0,), True),  # tie-heavy
        (10, 14, 8, 4, 4, 3, 5, (0, 2), True),  # tie-heavy + pins + wrap
    ],
)
def test_plain_path_matches_jax_xla(T, N, C, M, ctx, radius, knn, long_mem, ties):
    emb, seed = make_inputs(T, N, C, M, ties=ties)
    kw = dict(cxt_size=ctx, radius=radius, temperature=0.07, knn=knn, long_mem=long_mem)
    s_ref, p_ref = jax_propagate(jnp.asarray(emb), jnp.asarray(seed), JaxConfig(**kw), None, "xla")
    soft, pred = propagate_labels(emb, seed, LabelPropConfig(**kw), kernel="torch", device="cpu")
    assert soft.shape == (T, N, M) and pred.shape == (T, N)
    np.testing.assert_allclose(soft.numpy(), np.asarray(s_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(p_ref))


def test_auto_kernel_on_cpu_is_plain_and_single_frame_returns_seed():
    emb, seed = make_inputs(1, 6, 8, 3)
    cfg = LabelPropConfig(cxt_size=4, radius=3, temperature=0.1, knn=3)
    soft, pred = propagate_labels(emb, seed, cfg, device="cpu")
    np.testing.assert_array_equal(soft.numpy(), seed[None])
    np.testing.assert_array_equal(pred.numpy(), seed.argmax(-1)[None])


def _step_inputs(K, N, C, M, nslots, seed, ties=False):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((K, N, C)).astype(np.float32)
    query = rng.standard_normal((N, C)).astype(np.float32)
    if ties:
        feats, query = np.round(feats, 1), np.round(query, 1)
    else:
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        query /= np.linalg.norm(query, axis=-1, keepdims=True)
    labels = rng.random((K, N, M)).astype(np.float32)
    valid = (np.arange(K) < nslots) & (rng.random(K) < 0.8)
    valid[0] = True
    bias = np.where(valid, 0.0, NEG_INVALID).astype(np.float32)
    return feats, query, labels, bias


@pytest.mark.parametrize(
    "K,N,C,M,knn,radius,nslots,ties",
    [
        (9, 20, 16, 4, 6, 5.0, 9, False),  # full sweep
        (12, 5, 8, 3, 20, 3.0, 3, True),  # valid prefix < K, knn > candidates, ties
    ],
)
def test_step_matches_pallas_interpret(K, N, C, M, knn, radius, nslots, ties):
    feats, query, labels, bias = _step_inputs(K, N, C, M, nslots, seed=5, ties=ties)
    mask = radius_mask(N, 1, radius)
    want = prop_step_pallas(
        jnp.asarray(feats), jnp.asarray(query), jnp.asarray(mask), jnp.asarray(labels),
        jnp.asarray(bias), 0.07, knn, interpret=True,
        nslots=None if nslots == K else nslots,
    )
    t = [torch.from_numpy(a) for a in (feats, query, mask, bias, labels)]
    got = _prop_step(*t, 0.07, knn, nslots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the kernel wrapper on CPU tensors is the plain step, bit for bit
    via_wrapper = labelprop_cuda.prop_step(*t, 0.07, knn, nslots)
    assert torch.equal(via_wrapper, got)


def test_stable_sort_breaks_ties_toward_lowest_index():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 4, (7, 50)).astype(np.float32)
    _, idx = torch.sort(torch.from_numpy(vals), dim=1, descending=True, stable=True)
    want = np.stack([np.lexsort((np.arange(50), -row)) for row in vals])
    np.testing.assert_array_equal(idx.numpy(), want)


def test_mask_and_slot_validity_match_jax():
    np.testing.assert_array_equal(radius_mask(4, 5, 2.5), jax_radius_mask(4, 5, 2.5))
    for long_mem, cxt in [((0,), 5), ((0, 3), 4), ((), 3)]:
        t = np.arange(1, 14)
        want = np.stack([np.asarray(jax_slot_validity(long_mem, cxt, jnp.int32(i))) for i in t])
        got = _slot_validity(long_mem, cxt, torch.from_numpy(t))
        np.testing.assert_array_equal(got.numpy(), want)


def test_config_and_kernel_validation():
    emb, seed = make_inputs(3, 4, 8, 2)
    with pytest.raises(ValueError, match="cxt_size"):
        propagate_labels(emb, seed, LabelPropConfig(cxt_size=0), device="cpu")
    with pytest.raises(ValueError, match="knn"):
        propagate_labels(emb, seed, LabelPropConfig(knn=0), device="cpu")
    with pytest.raises(ValueError, match="long_mem"):
        propagate_labels(emb, seed, LabelPropConfig(long_mem=(2, 0)), device="cpu")
    with pytest.raises(ValueError, match="grid"):
        propagate_labels(emb, seed, LabelPropConfig(), grid_hw=(3, 3), device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        propagate_labels(emb, seed, LabelPropConfig(), kernel="xla", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        propagate_labels(emb, seed, LabelPropConfig(), kernel="cuda", device="cpu")


def test_grid_hw_mask_matches_jax():
    """A 2-D patch grid (h, w) changes only the radius mask."""
    emb, seed = make_inputs(6, 12, 8, 3, seed=4)
    kw = dict(cxt_size=3, radius=1.5, temperature=0.07, knn=4)
    s_ref, p_ref = jax_propagate(jnp.asarray(emb), jnp.asarray(seed), JaxConfig(**kw), (3, 4), "xla")
    soft, pred = propagate_labels(emb, seed, LabelPropConfig(**kw), (3, 4), "torch", device="cpu")
    np.testing.assert_allclose(soft.numpy(), np.asarray(s_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(p_ref))
