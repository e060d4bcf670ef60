"""The plain twin of the whole-sequence kernel vs the JAX seq kernel (CPU).

`propagate_labels_batched(kernel='torch')` (ops/labelprop.propagate_seq_reference,
the twin `csrc/prop_seq.cu` is held against on the card) against the Pallas
`_prop_seq_v2_kernel` in interpret mode: through the JAX
`propagate_labels_batched(kernel='pallas_seq_interpret')` and through
`propagate_all_pallas_v2_batched(interpret=True, packs=p)` for every lane
packing. Soft labels to rtol 1e-4 / atol 1e-6 (CPU products sum in other
orders on the two sides), argmax maps exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.ops.labelprop import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu.ops.labelprop import propagate_labels_batched as jax_batched
from radar_sounder_crw_tpu.ops.labelprop_pallas import propagate_all_pallas_v2_batched
from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
from radar_sounder_crw_tpu_torch.ops.labelprop import (
    LabelPropConfig,
    propagate_labels,
    propagate_labels_batched,
    propagate_seq_reference,
    radius_mask,
)

RTOL, ATOL = 1e-4, 1e-6
TEMP = 0.07


def make_inputs(R, T, N, C, M, seed, ties=False):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((R, T, N, C)).astype(np.float32)
    if ties:  # one decimal: many exactly equal affinities
        emb = np.round(emb, 1).astype(np.float32)
    else:
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    seeds = np.eye(M, dtype=np.float32)[rng.integers(0, M, (R, N))]
    return emb, seeds


def assert_matches(soft, pred, want_soft):
    want_soft = np.asarray(want_soft)
    assert soft.shape == want_soft.shape
    np.testing.assert_allclose(soft.numpy(), want_soft, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pred.numpy(), want_soft.argmax(-1))


# the shapes of tests/test_labelprop_pallas.py::test_seq_v2_batched_lane_packing
PACK_SHAPES = [
    (5, 7, 10, 8, 3, 4, (0,)),  # ring wraps; B uneven for packs 2 and 4
    (3, 6, 9, 8, 3, 8, (0,)),  # the prefix never saturates
    (4, 9, 12, 8, 4, 4, (0, 2)),  # multi-frame long_mem pins
]


@pytest.mark.parametrize("packs", [1, 2, 4, None])
@pytest.mark.parametrize("R,T,N,C,M,ctx,lm", PACK_SHAPES)
def test_twin_matches_lane_packed_seq_kernel(R, T, N, C, M, ctx, lm, packs):
    """All-zero mask and knn 3, as the JAX packing test: every packing is
    the same function, and the twin must equal each."""
    emb, seeds = make_inputs(R, T, N, C, M, seed=13)
    mask = np.zeros((N, N), np.float32)
    want = propagate_all_pallas_v2_batched(
        jnp.asarray(emb), jnp.asarray(seeds), jnp.asarray(mask), TEMP, 3, lm, ctx,
        interpret=True, packs=packs,
    )
    soft = propagate_seq_reference(
        torch.from_numpy(emb), torch.from_numpy(seeds), torch.from_numpy(mask), lm, ctx, TEMP, 3
    )
    assert_matches(soft, soft.argmax(-1), want)


@pytest.mark.parametrize(
    "R,T,N,C,M,ctx,radius,knn,lm,ties",
    [
        (2, 7, 10, 8, 3, 4, 3, 3, (0,), False),  # ring wraps
        (3, 6, 9, 8, 3, 8, 3, 3, (0,), False),  # unsaturated prefix
        (2, 9, 12, 8, 4, 4, 3, 3, (0, 2), False),  # pins
        (2, 8, 9, 8, 3, 3, 4, 5, (0, 2), True),  # tie-heavy + pins + wrap
        (2, 5, 6, 8, 3, 2, 4, 40, (0,), False),  # knn above the candidate count
    ],
)
def test_batched_twin_matches_jax_seq_interpret(R, T, N, C, M, ctx, radius, knn, lm, ties):
    emb, seeds = make_inputs(R, T, N, C, M, seed=9, ties=ties)
    kw = dict(cxt_size=ctx, radius=radius, temperature=TEMP, knn=knn, long_mem=lm)
    want, want_pred = jax_batched(
        jnp.asarray(emb), jnp.asarray(seeds), JaxConfig(**kw), None, "pallas_seq_interpret"
    )
    soft, pred = propagate_labels_batched(emb, seeds, LabelPropConfig(**kw), device="cpu")
    assert_matches(soft, pred, want)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want_pred))
    # each radargram alone through the unbatched entry point is the same
    for r in range(R):
        s_r, p_r = propagate_labels(emb[r], seeds[r], LabelPropConfig(**kw), kernel="torch",
                                    device="cpu")
        assert torch.equal(s_r, soft[r]) and torch.equal(p_r, pred[r])


def test_single_frame_returns_the_seeds():
    emb, seeds = make_inputs(2, 1, 8, 8, 3, seed=5)
    cfg = LabelPropConfig(cxt_size=3, radius=4, temperature=0.1, knn=2)
    soft, pred = propagate_labels_batched(emb, seeds, cfg, device="cpu")
    want, _ = jax_batched(jnp.asarray(emb), jnp.asarray(seeds),
                          JaxConfig(3, 4, 0.1, 2), None, "pallas_seq_interpret")
    np.testing.assert_array_equal(soft.numpy(), np.asarray(want))
    np.testing.assert_array_equal(soft.numpy(), seeds[:, None])
    np.testing.assert_array_equal(pred.numpy(), seeds.argmax(-1)[:, None])


def test_kernel_whitelist_and_device():
    emb, seeds = make_inputs(2, 3, 4, 8, 2, seed=1)
    cfg = LabelPropConfig(cxt_size=2, radius=2, temperature=0.1, knn=2)
    for bad in ("pallas_seq", "cuda_seq_interpret", "cuda-seq", "xla"):
        with pytest.raises(ValueError, match="unknown kernel"):
            propagate_labels_batched(emb, seeds, cfg, kernel=bad, device="cpu")
        with pytest.raises(ValueError, match="unknown kernel"):
            propagate_labels(emb[0], seeds[0], cfg, kernel=bad, device="cpu")
    for cuda in ("cuda", "cuda_seq"):
        with pytest.raises(ValueError, match="CUDA device"):
            propagate_labels_batched(emb, seeds, cfg, kernel=cuda, device="cpu")
        with pytest.raises(ValueError, match="CUDA device"):
            propagate_labels(emb[0], seeds[0], cfg, kernel=cuda, device="cpu")
    # 'auto' on the CPU is the plain path
    auto = propagate_labels_batched(emb, seeds, cfg, device="cpu")
    plain = propagate_labels_batched(emb, seeds, cfg, kernel="torch", device="cpu")
    assert torch.equal(auto[0], plain[0])


def test_prop_seq_wrapper_on_cpu_is_the_twin():
    emb, seeds = make_inputs(2, 6, 9, 8, 3, seed=4)
    e, s = torch.from_numpy(emb), torch.from_numpy(seeds)
    mask = torch.from_numpy(radius_mask(9, 1, 3))
    before = labelprop_cuda.launches["prop_seq"]
    got = labelprop_cuda.prop_seq(e, s, mask, (0, 2), 3, TEMP, 4)
    assert labelprop_cuda.launches["prop_seq"] == before  # no launch on the CPU
    assert torch.equal(got, propagate_seq_reference(e, s, mask, (0, 2), 3, TEMP, 4))
    assert torch.equal(got[:, 0], s)
