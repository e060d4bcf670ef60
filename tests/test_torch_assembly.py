"""The port's host assembly of a line's pixel map vs the JAX package (CPU):
`prediction_to_pixels`, `resize_nearest`, `splice_correction`,
`reverse_unfold_flip` and `integrate_flat_mcords3`, all equal to the JAX
package's functions (`radar_sounder_crw_tpu/infer/*`, `utils/resize.py`).

The port keeps a map in int8 where its classes fit (nclasses <= 127), else
int32; `utils.resize.paths` counts the column route of each resize: a
whole-number repeat for pixel maps, a gather for anything else (a seed
column). A small line assembled in the benchmark harness's order equals
the harness's plain reference, `portbench.reference.survey.assemble`.
"""

import numpy as np
import pytest
import torch

from portbench.reference import survey as ref_survey
from radar_sounder_crw_tpu.infer import PropagationPipeline as JaxPipeline
from radar_sounder_crw_tpu.infer import integrate as jax_integrate
from radar_sounder_crw_tpu.infer.correction import splice_correction as jax_splice
from radar_sounder_crw_tpu.ops import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu.utils.resize import resize_nearest as jax_resize_nearest
from radar_sounder_crw_tpu_torch.infer import (
    PropagationPipeline,
    correction_pixel_offset,
    integrate_flat_mcords3,
    reverse_unfold_flip,
    splice_correction,
)
from radar_sounder_crw_tpu_torch.infer.propagate import seed_onehot_from_segmentation
from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig
from radar_sounder_crw_tpu_torch.utils import resize
from radar_sounder_crw_tpu_torch.utils.resize import resize_nearest

LP = (10, 1.5, 0.1, 5)  # cxt, radius, temperature, knn: unused by the assembly
SURVEY = (410, 50, 100, 16, 0)  # H, N, T, w, ow of the Miguel line


def _pipes(nclasses):
    jp = JaxPipeline(None, {}, JaxConfig(*LP), nclasses=nclasses)
    tp = PropagationPipeline(torch.nn.Identity(), LabelPropConfig(*LP), nclasses, device="cpu")
    return jp, tp


def _layered(rng, H, W, nclasses, dtype):
    """A class map in bands by row whose borders wander by column, with
    patches of noise: runs as long as a real map's, every class present."""
    rows = np.arange(H)[:, None]
    walk = np.clip(rng.integers(-1, 2, W).cumsum(), -3, 3)
    out = sum((rows >= (k + 1) * H // nclasses + walk).astype(np.int64)
              for k in range(nclasses - 1))
    noise = rng.random((H, W)) < 0.02
    out[noise] = rng.integers(0, nclasses, int(noise.sum()))
    return np.clip(out, 0, nclasses - 1).astype(dtype)


@pytest.mark.parametrize("nclasses", [6, 200])
@pytest.mark.parametrize("in_dtype", [np.int8, np.int32, np.int64])
@pytest.mark.parametrize("shape,out_hw", [
    ((50, 100), (410, 1600)),  # the survey's radargram: whole-number column repeat
    ((50, 100), (410, 1599)),  # no whole multiple: a gather
    ((50, 16), (410, 1)),  # narrowing
    ((50, 7), (410, 112)),  # a correction's 16 * T' columns
])
def test_prediction_to_pixels_matches_jax(nclasses, in_dtype, shape, out_hw):
    rng = np.random.default_rng(shape[1] + out_hw[1])
    pred = rng.integers(0, min(nclasses, 128), shape).astype(in_dtype)
    jp, tp = _pipes(nclasses)
    before = pred.copy()
    got = tp.prediction_to_pixels(pred, out_hw)
    want = jp.prediction_to_pixels(pred, out_hw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == (np.int8 if nclasses <= 127 else np.int32)
    assert got.shape == out_hw and got.flags.writeable
    np.testing.assert_array_equal(pred, before)


@pytest.mark.parametrize("in_size", [1, 3, 7, 50, 100, 113])
def test_resize_nearest_matches_jax_at_whole_and_other_ratios(in_size):
    """Columns: every out = k * in for k up to 24 (the repeat route) and
    the widths beside them (the gather), in int8 and int64; other axes."""
    rng = np.random.default_rng(in_size)
    x = rng.integers(0, 6, (in_size, in_size))
    for k in range(1, 25):
        for out in {k * in_size - 1, k * in_size, k * in_size + 1} - {0}:
            for dtype in (np.int8, np.int64):
                xs = x.astype(dtype)
                got = resize_nearest(xs, (k + 2, out))
                np.testing.assert_array_equal(got, jax_resize_nearest(xs, (k + 2, out)))
                assert got.dtype == dtype
    x3 = rng.integers(0, 6, (2, in_size, 3))
    got = resize_nearest(x3, (4 * in_size, 5), axes=(1, 2))
    want = np.take(np.take(x3, resize._nearest_idx(4 * in_size, in_size), axis=1),
                   resize._nearest_idx(5, 3), axis=2)
    np.testing.assert_array_equal(got, want)


def test_nearest_index_is_cached_and_read_only():
    a = resize._nearest_idx(1600, 100)
    assert a is resize._nearest_idx(1600, 100)
    assert not a.flags.writeable
    assert resize._whole_repeat(1600, 100) == 16
    assert resize._whole_repeat(1599, 100) == 0
    assert resize._whole_repeat(1, 16) == 0


def test_paths_count_repeat_for_pixel_maps_and_take_for_seed_columns():
    H, N, T, w, _ = SURVEY
    _, tp = _pipes(6)
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 6, (N, T)).astype(np.int8)
    start = dict(resize.paths)
    for _ in range(3):
        tp.prediction_to_pixels(pred, (H, T * w))
    splice_correction(tp.prediction_to_pixels(pred, (H, T * w)), pred[:, :5], 5 * w)
    assert resize.paths["repeat"] - start["repeat"] == 5
    assert resize.paths["take"] == start["take"]
    seg = rng.integers(0, 6, (N * 8 + 10, w))
    seed_onehot_from_segmentation(seg, N, 6)
    assert resize.paths["take"] - start["take"] == 1
    assert resize.paths["repeat"] - start["repeat"] == 5


@pytest.mark.parametrize("px_dtype", [np.int8, np.int32])
def test_splice_correction_matches_jax_at_every_corrected_length(px_dtype):
    H, N, T, w, ow = SURVEY
    rg_len = T * (w - ow) + ow
    rng = np.random.default_rng(5)
    px = rng.integers(0, 6, (H, rg_len)).astype(px_dtype)
    before = px.copy()
    for small in range(2, T):
        off = correction_pixel_offset(small, w, ow)
        patch = rng.integers(0, 6, (N, small))
        got = splice_correction(px, patch, off)
        np.testing.assert_array_equal(got, jax_splice(px, patch, off))
        assert got.dtype == px_dtype
        np.testing.assert_array_equal(got[:, :-off], px[:, :-off])
    np.testing.assert_array_equal(px, before)


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64])
@pytest.mark.parametrize("floating", [True, False])
def test_integrate_flat_mcords3_matches_jax(dtype, floating):
    """Floating ice (4) in some reverse columns or in none; the inputs are
    left unmodified and the output keeps the forward map's dtype."""
    rng = np.random.default_rng(int(floating))
    H, W = 41, 480
    fwd = _layered(rng, H, W, 6, dtype)
    rev = _layered(rng, H, W, 6, dtype)
    if floating:
        rev[rev == 4] = 3
        rev[5:9, 100:160] = 4
        rev[30, 400] = 4
    else:
        rev[rev == 4] = 2
    assert (rev == 2).any() and (fwd == 3).any()
    fwd_flat, rev_in = fwd.ravel().copy(), rev.copy()
    got = integrate_flat_mcords3(fwd_flat, rev_in)
    want = jax_integrate.integrate_flat_mcords3(fwd.ravel(), rev)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == dtype and got.shape == (H * W,)
    assert not np.array_equal(got, fwd.ravel())  # the merge wrote something
    np.testing.assert_array_equal(fwd_flat, fwd.ravel())
    np.testing.assert_array_equal(rev_in, rev)
    flipped = reverse_unfold_flip(rev, 160)  # a flipped view's copy, as the line's
    np.testing.assert_array_equal(integrate_flat_mcords3(fwd_flat, flipped),
                                  jax_integrate.integrate_flat_mcords3(fwd.ravel(), flipped))


@pytest.mark.parametrize("use_last", [True, False])
def test_line_assembled_in_harness_order_matches_reference(use_last):
    """A line of 5 radargrams (H 82, N 10, T 12, w 16, ow 0) with two
    corrections, assembled as `portbench/entries/survey.py` does from int8
    pass maps, equals the harness's plain reference."""
    H, N, T, w, ow = 82, 10, 12, 16, 0
    R, rg_len = 5, T * (w - ow) + ow
    rng = np.random.default_rng(7)
    fwd = np.stack([_layered(rng, N, T, 6, np.int8) for _ in range(R)])
    rev = np.stack([_layered(rng, N, T, 6, np.int8) for _ in range(R)]) if use_last else None
    change = [None, 4, T - 1, 9, None]
    corrected = {(T - c, t): _layered(rng, N, T - c, 6, np.int8)
                 for t, c in enumerate(change) if c is not None and c < T - 1}
    _, tp = _pipes(6)
    px = [tp.prediction_to_pixels(f, (H, rg_len)) for f in fwd]
    for (small, t), pred in corrected.items():
        px[t] = splice_correction(px[t], pred, correction_pixel_offset(small, w, ow))
    final = np.concatenate(px, axis=1).ravel()
    if use_last:
        rev_px = [tp.prediction_to_pixels(r, (H, rg_len)) for r in rev]
        final = integrate_flat_mcords3(final, reverse_unfold_flip(
            np.concatenate(rev_px, axis=1), rg_len))
    assert final.dtype == np.int8
    want = ref_survey.assemble(fwd, change, corrected, rev, H, T, w, ow, "mcords3_flat")
    np.testing.assert_array_equal(final, want)


@pytest.mark.parametrize("threads", [1, 3])
def test_line_sized_flip_and_merge_by_row_bands_match_jax(threads):
    """A 410 x 16,000 int8 map (6.6 MB: one band a thread, here 1 or 3):
    the flip back and the flat merge equal the JAX package's."""
    H, rg_len, R = 410, 1600, 10
    rng = np.random.default_rng(threads)
    fwd = _layered(rng, H, R * rg_len, 6, np.int8)
    rev = _layered(rng, H, R * rg_len, 6, np.int8)
    rev[rev == 4] = 3
    rev[50:60, 3000:3500] = 4
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        flipped = reverse_unfold_flip(rev, rg_len)
        merged = integrate_flat_mcords3(fwd.ravel(), flipped)
    finally:
        torch.set_num_threads(saved)
    want_flip = jax_integrate.reverse_unfold_flip(rev, rg_len)
    np.testing.assert_array_equal(flipped, want_flip)
    assert flipped.dtype == np.int8 and flipped.flags.c_contiguous
    np.testing.assert_array_equal(merged, jax_integrate.integrate_flat_mcords3(fwd.ravel(),
                                                                               want_flip))
    assert merged.dtype == np.int8
