"""PyTorch port seed->map pipeline vs the JAX PropagationPipeline (CPU).

Shared weights (tests/test_torch_encoders.py), a synthetic 8-frame window of
16x16 patches. Tolerances:
  * margin fixture (radius 1.5, knn above the candidate count, so no top-k
    boundary exists and every argmax margin is checked to exceed 1e-4):
    maps exactly equal;
  * generic fixture (radius 4, knn 5, a wrapping ring): >= 99.5 % of the
    map equal, since encoder outputs differ by ~1e-6 and a top-k boundary
    that close may flip;
  * xent to atol 1e-4, change_idx equal.
The host-side numpy copies (synthetic data, PELT, resize, patchify) are held
exactly equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.data.patchify import extract_window as jax_extract_window
from radar_sounder_crw_tpu.data.patchify import window_geometry as jax_window_geometry
from radar_sounder_crw_tpu.data.synthetic import synthetic_radargram as jax_synthetic
from radar_sounder_crw_tpu.infer import PropagationPipeline as JaxPipeline
from radar_sounder_crw_tpu.ops import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu.ops import pelt as jax_pelt
from radar_sounder_crw_tpu.ops.xent_metric import column_diffs as jax_column_diffs
from radar_sounder_crw_tpu.ops.xent_metric import horizontality_xent as jax_xent
from radar_sounder_crw_tpu.utils.pos_embed import pos_embed as jax_pos_embed
from radar_sounder_crw_tpu.utils.resize import resize_nearest as jax_resize_nearest
from radar_sounder_crw_tpu_torch.data import extract_window, synthetic_radargram, window_geometry
from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
from radar_sounder_crw_tpu_torch.infer.propagate import (
    encode_sequence,
    seed_onehot_from_segmentation,
)
from radar_sounder_crw_tpu_torch.ops import pelt
from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig, propagate_labels
from radar_sounder_crw_tpu_torch.ops.xent_metric import column_diffs, horizontality_xent
from radar_sounder_crw_tpu_torch.utils.pos_embed import pos_embed
from radar_sounder_crw_tpu_torch.utils.resize import resize_nearest
from test_torch_encoders import jax_and_torch_models

T, NCLS = 8, 4
MARGIN = dict(cxt_size=10, radius=1.5, temperature=0.1, knn=40)
GENERIC = dict(cxt_size=4, radius=4, temperature=0.05, knn=5)


@pytest.fixture(scope="module")
def window():
    rg, seg = synthetic_radargram(H=128, W=256, nclasses=NCLS, seed=21, change_point=0.5)
    geo = window_geometry(rg.shape, (16, 16), (8, 0), T)
    seq = extract_window(rg, geo, 0)

    def seg_at(frame):  # the seed patch covering one frame's pixels
        c0 = geo.col_start(frame)
        return seg[: geo.rg_h(), c0 : c0 + geo.w]

    return seq, seg_at(0), seg_at(3), seg_at(T - 1)


@pytest.fixture(scope="module")
def models():
    return jax_and_torch_models(1, False)


def _pipelines(models, cfg, **kw):
    jmodel, variables, tmodel = models
    jp = JaxPipeline(jmodel, variables, JaxConfig(**cfg), nclasses=NCLS, **kw)
    tp = PropagationPipeline(tmodel, LabelPropConfig(**cfg), NCLS, device="cpu", **kw)
    return jp, tp


@pytest.mark.parametrize("use_last", [False, True])
def test_margin_fixture_maps_equal(window, models, use_last):
    seq, seg_first, seg_ref3, seg_last = window
    seg_ref = seg_last if use_last else seg_first
    jp, tp = _pipelines(models, MARGIN)
    want = jp(seq, seg_ref, use_last=use_last, return_soft=True)
    got = tp(seq, seg_ref, use_last=use_last, return_soft=True)
    top2 = np.sort(want.soft, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4, "fixture lost its margins"
    np.testing.assert_array_equal(got.prediction, want.prediction)
    np.testing.assert_allclose(got.soft, want.soft, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.xent, want.xent, rtol=0, atol=1e-4)
    assert got.change_idx == want.change_idx
    # reseed mid-sequence on the cached embeddings, on both sides
    np.testing.assert_array_equal(
        tp.reseed(seg_ref3, 3).prediction, jp.reseed(seg_ref3, 3).prediction
    )


def test_generic_fixture_agreement(window, models):
    seq, seg_ref, _, _ = window
    jp, tp = _pipelines(models, GENERIC)
    want = jp(seq, seg_ref)
    got = tp(seq, seg_ref)
    assert (got.prediction == want.prediction).mean() >= 0.995
    np.testing.assert_allclose(got.xent, want.xent, rtol=0, atol=1e-4)
    assert got.change_idx == want.change_idx


def test_call_options(window, models):
    seq, seg_ref, _, _ = window
    _, tp = _pipelines(models, GENERIC)
    base = tp(seq, seg_ref, detect_change=False)
    assert base.prediction.shape == (15, T) and base.prediction.dtype == np.int32
    assert base.xent.shape == (15, T - 1) and base.soft is None
    assert base.change_idx is None
    soft = tp(seq, seg_ref, return_soft=True)
    assert soft.soft.shape == (T, 15, NCLS)
    np.testing.assert_array_equal(soft.soft.argmax(-1).T, base.prediction)
    lean = tp(seq, seg_ref, detect_change=False, fetch_xent=False)
    assert lean.xent is None
    np.testing.assert_array_equal(lean.prediction, base.prediction)
    # use_last == the pipeline on the manually time-flipped sequence
    rev = tp(seq, seg_ref, use_last=True)
    manual = tp(np.ascontiguousarray(seq[::-1]), seg_ref)
    np.testing.assert_array_equal(rev.prediction, manual.prediction)
    # change detection needs T >= 4
    assert tp(seq[:3], seg_ref).change_idx is None
    px = tp.prediction_to_pixels(base.prediction, (128, 128))
    np.testing.assert_array_equal(px, jax_resize_nearest(base.prediction, (128, 128)))


def test_reseed_semantics(window, models):
    seq, seg, _, _ = window
    N = seq.shape[1]
    rng = np.random.default_rng(3)
    _, tp = _pipelines(models, GENERIC)
    with pytest.raises(RuntimeError, match="prior __call__"):
        tp.reseed(seg)
    res = tp(seq, seg, detect_change=False)
    re0 = tp.reseed(seg, 0)
    np.testing.assert_array_equal(re0.prediction, res.prediction)
    np.testing.assert_array_equal(re0.xent, res.xent)

    seg2 = rng.integers(0, NCLS, seg.shape)
    k = 4
    rek = tp.reseed(seg2, k)
    np.testing.assert_array_equal(rek.prediction[:, :k], res.prediction[:, :k])
    emb = encode_sequence(tp.model, torch.from_numpy(seq), False, False)
    seed2, labels2 = seed_onehot_from_segmentation(seg2, N, NCLS)
    _, tail = propagate_labels(emb[k:], seed2, tp.lp_cfg, device="cpu")
    np.testing.assert_array_equal(rek.prediction[:, k:], tail.T.numpy())

    # the last frame is a legal reseed; earlier frames keep the CURRENT map,
    # so refinements accumulate
    relast = tp.reseed(seg2, T - 1)
    np.testing.assert_array_equal(relast.prediction[:, : T - 1], rek.prediction[:, : T - 1])
    np.testing.assert_array_equal(relast.prediction[:, T - 1], labels2)
    for bad in (T, -1):
        with pytest.raises(ValueError, match="frame_idx"):
            tp.reseed(seg, bad)
    with pytest.raises(ValueError, match="bucket"):
        tp.reseed(seg2, 0, bucket=0)

    # bucketed tails (zero frames appended) equal the exact-length run
    res = tp(seq, seg, detect_change=False)
    for f in (0, 3, 7):
        a = tp.reseed(seg2, f, bucket=1)
        b = tp.reseed(seg2, f, bucket=16)
        np.testing.assert_array_equal(a.prediction, b.prediction)

    tp.release_cache()
    with pytest.raises(RuntimeError, match="prior __call__"):
        tp.reseed(seg)
    _, nocache = _pipelines(models, GENERIC, cache_embeddings=False)
    np.testing.assert_array_equal(nocache(seq, seg, detect_change=False).prediction, res.prediction)
    with pytest.raises(RuntimeError, match="prior __call__"):
        nocache.reseed(seg)


@pytest.mark.parametrize(
    "H,W,ncls,seed,cp", [(64, 96, 4, 11, 0.6), (80, 130, 5, 3, None), (410, 300, 6, 11, 0.6)]
)
def test_synthetic_radargram_byte_identical(H, W, ncls, seed, cp):
    rg_j, seg_j = jax_synthetic(H=H, W=W, nclasses=ncls, seed=seed, change_point=cp)
    rg_t, seg_t = synthetic_radargram(H=H, W=W, nclasses=ncls, seed=seed, change_point=cp)
    assert rg_t.dtype == rg_j.dtype and seg_t.dtype == seg_j.dtype
    assert rg_t.tobytes() == rg_j.tobytes() and seg_t.tobytes() == seg_j.tobytes()


def test_window_geometry_and_extract_match():
    rg, _ = synthetic_radargram(H=410, W=400, nclasses=6)
    for dim, overlap, length, index in [((32, 32), (30, 0), 10, 2), ((16, 16), (8, 4), 7, 5)]:
        gj = jax_window_geometry(rg.shape, dim, overlap, length)
        gt = window_geometry(rg.shape, dim, overlap, length)
        assert (gt.nh, gt.nw, gt.pxh, gt.pxw, gt.rg_h(), gt.rg_len()) == (
            gj.nh, gj.nw, gj.pxh, gj.pxw, gj.rg_h(), gj.rg_len())
        np.testing.assert_array_equal(
            extract_window(rg, gt, index), jax_extract_window(rg, gj, index)
        )
    with pytest.raises(IndexError):
        extract_window(rg, gt, gt.nw)


def test_resize_and_pos_embed_match():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 6, (37, 11))
    for out in [(190, 1), (5, 3), (37, 11), (400, 23)]:
        np.testing.assert_array_equal(resize_nearest(x, out), jax_resize_nearest(x, out))
    p = rng.standard_normal((3, 5, 7, 1)).astype(np.float32)
    want = np.asarray(jax_pos_embed(jnp.asarray(p)))  # NHWC
    got = pos_embed(torch.from_numpy(p).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("row_softmax", [False, True])
def test_xent_matches(quirk, row_softmax):
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((6, 9, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    want = np.asarray(jax_xent(jnp.asarray(emb), 0.1, quirk_channel_shift=quirk,
                               row_softmax=row_softmax))
    got = horizontality_xent(torch.from_numpy(emb), 0.1, quirk_channel_shift=quirk,
                             row_softmax=row_softmax)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        column_diffs(got).numpy(), np.asarray(jax_column_diffs(jnp.asarray(want))),
        rtol=1e-5, atol=1e-4,
    )


def test_pelt_matches():
    rng = np.random.default_rng(2)
    for n in (3, 12, 40, 97):
        sig = rng.standard_normal(n)
        sig[n // 2:] += 3.0
        assert pelt.pelt_rbf(sig, pen=5.0) == jax_pelt.pelt_rbf(sig, pen=5.0)
        assert pelt.detect_change_point(sig) == jax_pelt.detect_change_point(sig)
        np.testing.assert_array_equal(pelt.rbf_gram(sig), jax_pelt.rbf_gram(sig))
