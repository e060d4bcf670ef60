"""The port's datasets, device windowing and survey inference vs the JAX
package (CPU).

Host-side copies (geometry, RGWindows, ConcatWindows, trim_miguel, the
registry with its synthetic fallback) are held byte for byte to the JAX
package's; `gather_windows` exactly to `extract_window` and to the JAX
gather. `PropagationPipeline.propagate_survey` is held to the JAX
`propagate_survey` on the fixture of tests/test_survey_resident.py, with the
flax weights carried over by `state_dict_from_jax`. Rules, as in
tests/test_torch_pipeline.py: on the margin fixture (radius 1.5, knn above
the valid candidate count, every argmax margin above 1e-4) the maps are
equal; on the generic fixture (knn 3, a wrapping ring) >= 99.5 % of the map
is equal, since the encoders differ by ~1e-6 and a top-k boundary that close
may flip; xent to atol 1e-4; change indices equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.data import ConcatWindows as JaxConcat
from radar_sounder_crw_tpu.data import RGWindows as JaxRGWindows
from radar_sounder_crw_tpu.data import registry as jax_registry
from radar_sounder_crw_tpu.data.device_windows import gather_windows as jax_gather
from radar_sounder_crw_tpu.data.radargram import trim_miguel as jax_trim_miguel
from radar_sounder_crw_tpu.infer import PropagationPipeline as JaxPipeline
from radar_sounder_crw_tpu.infer import integrate as jax_integrate
from radar_sounder_crw_tpu.infer.correction import splice_correction as jax_splice
from radar_sounder_crw_tpu.ops import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu_torch.data import (
    ConcatWindows,
    RGWindows,
    SubsetWindows,
    extract_window,
    gather_windows,
    synthetic_radargram,
    trim_miguel,
)
from radar_sounder_crw_tpu_torch.data import registry
from radar_sounder_crw_tpu_torch.infer import (
    PropagationPipeline,
    correction_pixel_offset,
    integrate_bidirectional,
    integrate_flat_mcords3,
    reverse_unfold_flip,
    splice_correction,
)
from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig
from test_torch_encoders import jax_and_torch_models

T, NCLS = 8, 4
GENERIC = (4, 4, 0.1, 3)  # cxt, radius, temperature, knn: the JAX fixture's
MARGIN = (10, 1.5, 0.1, 40)
AGREEMENT = 0.995


@pytest.fixture(scope="module")
def fixture():
    rg, seg = synthetic_radargram(H=72, W=800, nclasses=NCLS, seed=3)
    ds = RGWindows(rg, length=T, dim=(16, 16), overlap=(8, 0))
    jds = JaxRGWindows(rg, length=T, dim=(16, 16), overlap=(8, 0))
    ids = list(range(0, len(ds), T))[:5]
    geo = ds.geo
    refs = [seg[: geo.rg_h(), geo.col_start(i) : geo.col_start(i) + 16] for i in ids]
    return ds, jds, ids, refs


@pytest.fixture(scope="module")
def models():
    return jax_and_torch_models(0, False)


def _pipes(models, lp, **kw):
    jmodel, variables, tmodel = models
    jp = JaxPipeline(jmodel, variables, JaxConfig(*lp), nclasses=NCLS, **kw)
    tp = PropagationPipeline(tmodel, LabelPropConfig(*lp), NCLS, device="cpu", **kw)
    return jp, tp


@pytest.fixture(scope="module")
def generic(models):
    return _pipes(models, GENERIC)


def _agree(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got == want).mean() >= AGREEMENT


# -- host-side copies --------------------------------------------------------


def test_geometry_windows_and_concat_match():
    rg, _ = synthetic_radargram(H=96, W=700, nclasses=5, seed=2)
    for kw in (dict(length=6, dim=(16, 16), overlap=(8, 0)),
               dict(length=5, dim=(16, 12), overlap=(8, 4), flip=True)):
        a, b = RGWindows(rg, **kw), JaxRGWindows(rg, **kw)
        assert a.rg.tobytes() == b.rg.tobytes() and len(a) == len(b)
        assert a.geo.num_items == b.geo.num_items and a.item_shape == b.item_shape
        for L, W in ((None, None), (3, None), (4, 500)):
            assert a.geo.num_windows(L, W) == b.geo.num_windows(L, W)
        for i in (0, len(a) - 1):
            assert a[i].tobytes() == b[i].tobytes()
            assert a.get_smaller_item(i, 3).tobytes() == b.get_smaller_item(i, 3).tobytes()
        assert list(a.non_overlapping_indices()) == list(b.non_overlapping_indices())
        assert a.batch([0, 2], 2).tobytes() == b.batch([0, 2], 2).tobytes()
    parts = [synthetic_radargram(H=96, W=w, nclasses=4, seed=s)[0] for s, w in ((1, 300), (2, 420))]
    cat = ConcatWindows([RGWindows(p, length=4, dim=(16, 16), overlap=(8, 0)) for p in parts])
    jcat = JaxConcat([JaxRGWindows(p, length=4, dim=(16, 16), overlap=(8, 0)) for p in parts])
    assert len(cat) == len(jcat)
    for i in (0, len(cat) // 2, len(cat) - 1):
        assert cat[i].tobytes() == jcat[i].tobytes()
    with pytest.raises(IndexError):
        cat[len(cat)]
    with pytest.raises(ValueError, match="too narrow"):
        RGWindows(rg[:, :40], length=6, dim=(16, 16))


def test_trim_miguel_matches():
    rg = np.arange(4 * 105120, dtype=np.float32).reshape(4, 105120)
    for length, dim in ((100, (16, 16)), (10, (32, 32))):
        assert trim_miguel(rg, length, dim).tobytes() == jax_trim_miguel(rg, length, dim).tobytes()


def test_registry_matches_byte_for_byte(monkeypatch, capsys):
    """Synthetic fallback at RSCRW_SYNTH_SCALE (ids 0, 2, 3); id 1 (the
    full-width Miguel line, absolute trim offsets) runs on a shallow stand-in
    pair planted in both caches."""
    monkeypatch.setenv("RSCRW_DATA_ROOT", "/nonexistent-rscrw-root")
    monkeypatch.setenv("RSCRW_SYNTH_SCALE", "8")
    miguel = synthetic_radargram(H=40, W=105120, nclasses=6, seed=11)
    monkeypatch.setitem(registry._synth_cache, (1, 8), miguel)
    monkeypatch.setitem(jax_registry._synth_cache, (1, 8), miguel)
    for id_, length, dim, overlap in ((0, 10, (24, 24), (0, 0)), (3, 6, (16, 16), (8, 0)),
                                      (1, 10, (16, 16), (8, 0))):
        for full in (True, False):
            a = registry.create_dataset(id_, length, dim, overlap, full=full)
            out_a = capsys.readouterr().out
            b = jax_registry.create_dataset(id_, length, dim, overlap, full=full)
            assert capsys.readouterr().out == out_a
            assert len(a) == len(b) and a[len(a) - 1].tobytes() == b[len(b) - 1].tobytes()
        assert isinstance(a, SubsetWindows) and a.indices == b.indices
        assert a.get_smaller_item(1, 3).tobytes() == b.get_smaller_item(1, 3).tobytes()
    for id_, kw in ((0, {}), (2, {}), (3, dict(flip=True)), (1, dict(length=10, dim=(16, 16)))):
        na, sa = registry.get_reference(id_, h=30, w=0, **kw)
        out_a = capsys.readouterr().out
        nb, sb = jax_registry.get_reference(id_, h=30, w=0, **kw)
        assert capsys.readouterr().out == out_a
        assert na == nb and sa.dtype == sb.dtype and sa.tobytes() == sb.tobytes()
    ra, sa = registry.load_raw_pair(3)
    rb, sb = jax_registry.load_raw_pair(3)
    assert ra.tobytes() == rb.tobytes() and sa.tobytes() == sb.tobytes()
    with pytest.raises(ValueError, match="unknown dataset id"):
        registry.create_dataset(2, 10, (16, 16), (0, 0))
    with pytest.raises(ValueError, match="unknown reference id"):
        registry.get_reference(7, h=10, w=0)


def test_registry_refuses_a_half_populated_root(monkeypatch, tmp_path):
    seg = tmp_path / "SHARAD" / "sharad_north_sg5.pt"
    seg.parent.mkdir()
    torch.save(torch.zeros(4, 4), seg)
    monkeypatch.setenv("RSCRW_DATA_ROOT", str(tmp_path))
    with pytest.raises(ValueError, match="real SHARAD segmentation but not the real radargram"):
        registry.get_reference(3, h=4, w=0)
    rg = tmp_path / "SHARAD" / "sharad_north_rg.pt"
    torch.save(torch.arange(12.0).reshape(3, 4), rg)
    n, s = registry.get_reference(3, h=4, w=2)
    assert n == 5 and s.shape == (4, 2)
    np.testing.assert_array_equal(registry.load_raw_pair(3)[0], np.arange(12.0).reshape(3, 4))


def test_correction_and_integration_match():
    rng = np.random.default_rng(0)
    fwd = rng.integers(0, 6, (20, 48))
    rev = rng.integers(0, 6, (20, 48))
    for style in ("mcords1", "mcords3", "bedrock_only"):
        np.testing.assert_array_equal(
            integrate_bidirectional(fwd, rev, style),
            jax_integrate.integrate_bidirectional(fwd, rev, style),
        )
    with pytest.raises(ValueError, match="integration style"):
        integrate_bidirectional(fwd, rev, "other")
    np.testing.assert_array_equal(reverse_unfold_flip(fwd, 16),
                                  jax_integrate.reverse_unfold_flip(fwd, 16))
    np.testing.assert_array_equal(integrate_flat_mcords3(fwd.ravel(), rev),
                                  jax_integrate.integrate_flat_mcords3(fwd.ravel(), rev))
    off = correction_pixel_offset(3, 16, 8)
    assert off == 24
    patch = rng.integers(0, 6, (5, 3))
    np.testing.assert_array_equal(splice_correction(fwd, patch, off), jax_splice(fwd, patch, off))


# -- device windowing ---------------------------------------------------------


def test_gather_windows_is_extract_window(fixture):
    ds = fixture[0]
    geo = ds.geo
    rg = torch.from_numpy(ds.rg)
    ids = np.array([0, 3, len(ds) - 1])
    for length in (None, 5):
        got = gather_windows(rg, ids, geo, length).numpy()
        want = np.stack([extract_window(ds.rg, geo, i, length) for i in ids])
        assert got.tobytes() == want.tobytes()
        jgot = np.asarray(jax_gather(jnp.asarray(ds.rg), jnp.asarray(ids), geo, length))
        assert got.tobytes() == jgot.tobytes()
    # a tensor of indices takes the same path, unchecked
    assert torch.equal(gather_windows(rg, torch.from_numpy(ids), geo), gather_windows(rg, ids, geo))
    for bad in ([len(ds)], [-1]):
        with pytest.raises(IndexError):
            gather_windows(rg, bad, geo)
    # one frame shorter has one more valid start
    gather_windows(rg, [geo.num_windows(T - 1) - 1], geo, T - 1)


def test_gather_windows_stacked(fixture):
    parts = [synthetic_radargram(H=72, W=w, nclasses=4, seed=s)[0] for s, w in ((5, 128), (6, 200))]
    sets = [RGWindows(p, length=6, dim=(16, 16), overlap=(8, 0)) for p in parts]
    geo = sets[0].geo
    stack = np.zeros((2, geo.pxh, 200), np.float32)
    for i, s in enumerate(sets):
        stack[i, :, : s.rg.shape[1]] = s.rg[: geo.pxh]
    pairs = np.array([[0, 0], [1, 1], [1, len(sets[1]) - 1], [0, len(sets[0]) - 1]])
    got = gather_windows(torch.from_numpy(stack), pairs, geo).numpy()
    want = np.stack([sets[d][w] for d, w in pairs])
    assert got.tobytes() == want.tobytes()
    jgot = np.asarray(jax_gather(jnp.asarray(stack), jnp.asarray(pairs), geo))
    assert got.tobytes() == jgot.tobytes()
    for bad in ([[2, 0]], [[0, -1]], [[1, 100]]):
        with pytest.raises(IndexError):
            gather_windows(torch.from_numpy(stack), np.array(bad), geo)
    with pytest.raises(ValueError, match="index pairs"):
        gather_windows(torch.from_numpy(stack), np.array([0, 1]), geo)


# -- survey inference ---------------------------------------------------------


def test_survey_forward_matches_jax_and_own_paths(fixture, generic):
    ds, jds, ids, refs = fixture
    jp, tp = generic
    want, ch_want = jp.propagate_survey(jds, ids, refs, detect_change=True)
    got, ch_got = tp.propagate_survey(ds, ids, refs, detect_change=True)
    _agree(got, want)
    assert ch_got == ch_want
    # the port's survey is its per-radargram path, radargram by radargram
    for k, (i, r) in enumerate(zip(ids, refs)):
        res = tp(ds[i], r)
        np.testing.assert_array_equal(got[k], res.prediction, err_msg=f"rg {k}")
        assert res.change_idx == ch_got[k]


def test_survey_reverse_and_xent_match_jax(fixture, generic):
    ds, jds, ids, refs = fixture
    jp, tp = generic
    rev = tp.propagate_survey(ds, ids, refs, use_last=True)
    _agree(rev, jp.propagate_survey(jds, ids, refs, use_last=True))
    pred, xent = tp.propagate_survey(ds, ids, refs, return_xent=True)
    _, jxent = jp.propagate_survey(jds, ids, refs, return_xent=True)
    assert xent.shape == (len(ids), ds.geo.nh, T - 1)
    np.testing.assert_allclose(xent, np.asarray(jxent), rtol=0, atol=1e-4)
    for k, (i, r) in enumerate(zip(ids, refs)):
        np.testing.assert_array_equal(tp(ds[i], r, use_last=True).prediction, rev[k])
        np.testing.assert_array_equal(tp(ds[i], r, detect_change=False).xent, xent[k])


def test_survey_correction_head_and_tail_match_jax(fixture, generic):
    ds, jds, ids, refs = fixture
    jp, tp = generic
    head = tp.propagate_survey(ds, ids, refs, length=5)
    _agree(head, jp.propagate_survey(jds, ids, refs, length=5))
    for k, (i, r) in enumerate(zip(ids, refs)):
        np.testing.assert_array_equal(
            head[k], tp(ds.get_smaller_item(i, 5), r, detect_change=False).prediction)
    ci = 3
    tail = tp.propagate_survey(ds, ids, refs, length=T - ci, frame_offsets=[ci] * len(ids))
    _agree(tail, jp.propagate_survey(jds, ids, refs, length=T - ci,
                                     frame_offsets=[ci] * len(ids)))
    for k, (i, r) in enumerate(zip(ids, refs)):
        np.testing.assert_array_equal(tail[k], tp(ds[i][ci:], r, detect_change=False).prediction)


def test_survey_margin_fixture_maps_equal(fixture, models):
    ds, jds, ids, refs = fixture
    jp, tp = _pipes(models, MARGIN)
    seqs = np.stack([ds[i] for i in ids])
    soft = jp(seqs[0], refs[0], return_soft=True).soft
    top2 = np.sort(soft, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4, "fixture lost its margins"
    for kw in (dict(detect_change=True), dict(use_last=True)):
        want = jp.propagate_survey(jds, ids, refs, **kw)
        got = tp.propagate_survey(ds, ids, refs, **kw)
        if "detect_change" in kw:
            assert got[1] == want[1]
            got, want = got[0], want[0]
        np.testing.assert_array_equal(got, want)


def test_survey_stacked_source_matches_jax(models):
    patch, overlap, Tw = (16, 16), (8, 0), 6
    rgs, segs = zip(*[synthetic_radargram(H=72, W=Tw * 16 + extra, nclasses=4, seed=s)
                      for s, extra in ((5, 0), (6, 3), (7, 7))])
    cat = ConcatWindows([RGWindows(r, length=Tw, dim=patch, overlap=overlap) for r in rgs])
    jcat = JaxConcat([JaxRGWindows(r, length=Tw, dim=patch, overlap=overlap) for r in rgs])
    jp, tp = _pipes(models, GENERIC)
    refs = [s[: cat.geo.rg_h(), :16] for s in segs]
    for kw in (dict(), dict(use_last=True), dict(length=Tw - 2, frame_offsets=[2] * 3)):
        got = tp.propagate_survey(cat, [0, 1, 2], refs, **kw)
        _agree(got, jp.propagate_survey(jcat, [0, 1, 2], refs, **kw))
    for k in range(3):
        res = tp(cat.datasets[k][0][2:], refs[k], detect_change=False)
        np.testing.assert_array_equal(got[k], res.prediction)
    # widths 96 and 160: an offset window that fits the wider segment but
    # overruns segment 0 (end column 4*16 + 4*16 = 128)
    wide = ConcatWindows([RGWindows(synthetic_radargram(H=72, W=Tw * 16 + extra, nclasses=4,
                                                        seed=s)[0],
                                    length=Tw, dim=patch, overlap=overlap)
                          for s, extra in ((5, 0), (6, 64))])
    with pytest.raises(IndexError, match="segment 0"):
        tp.propagate_survey(wide, [0, 1], refs[:2], length=4, frame_offsets=[4, 4])
    assert tp.propagate_survey(wide, [1], refs[:1], length=4, frame_offsets=[4]).shape == (
        1, wide.geo.nh, 4)


def test_survey_bn_train_mode_matches_jax(fixture, models):
    ds, jds, ids, refs = fixture
    jp, tp = _pipes(models, GENERIC, bn_train_mode=True)
    got = tp.propagate_survey(ds, ids, refs)
    _agree(got, jp.propagate_survey(jds, ids, refs))
    # batch statistics stay per radargram: the survey equals the sequential path
    for k, (i, r) in enumerate(zip(ids, refs)):
        np.testing.assert_array_equal(got[k], tp(ds[i], r, detect_change=False).prediction)


def test_seed_labels_wrap_and_refuse_like_np_eye(fixture, generic):
    ds, jds, ids, refs = fixture
    jp, tp = generic
    neg = [np.where(r == 1, -1, r) for r in refs[:2]]  # -1 wraps to class 3
    got = tp.propagate_survey(ds, ids[:2], neg)
    _agree(got, jp.propagate_survey(jds, ids[:2], neg))
    np.testing.assert_array_equal(got[0], tp(ds[ids[0]], neg[0], detect_change=False).prediction)
    N = ds.geo.nh
    labels = tp._stack_seed_labels(neg, N)
    np.testing.assert_array_equal(labels, jp._stack_seed_labels(neg, N))
    assert labels.dtype == np.int8 and labels.min() >= 0
    for bad in (NCLS, -NCLS - 1):  # out of np.eye's range: IndexError on both sides
        with pytest.raises(IndexError):
            tp.propagate_survey(ds, ids[:1], [np.full_like(refs[0], bad)])
        with pytest.raises(IndexError):
            jp.propagate_survey(jds, ids[:1], [np.full_like(refs[0], bad)])


def test_survey_validates_ids_and_memoizes_the_upload(fixture, generic):
    ds, _, ids, refs = fixture
    _, tp = generic
    with pytest.raises(IndexError):
        tp.propagate_survey(ds, [len(ds) + 5], refs[:1])
    with pytest.raises(IndexError):
        tp.propagate_survey(ds, [-1], refs[:1])
    with pytest.raises(ValueError, match="frame_offsets"):
        tp.propagate_survey(ds, ids, refs, frame_offsets=[1])
    with pytest.raises(IndexError):
        tp.propagate_survey(ds, [len(ds) - 1], refs[:1], frame_offsets=[5])
    with pytest.raises(ValueError, match="window_ids"):
        tp.propagate_survey(ds, [ids], refs)
    with pytest.raises(TypeError):
        tp.propagate_survey(np.zeros((4, 4)), [0], refs[:1])
    tp.propagate_survey(ds, ids[:1], refs[:1])
    memo = tp._rg_memo[1]
    tp.propagate_survey(ds, ids[:1], refs[:1], use_last=True)
    tp.propagate_survey(ds, ids[:1], refs[:1], length=5)
    assert tp._rg_memo[1] is memo
    # the subset view maps its positions before gathering
    sub = SubsetWindows(ds, list(ds.non_overlapping_indices()))
    np.testing.assert_array_equal(tp.propagate_survey(sub, [0, 1], refs[:2]),
                                  tp.propagate_survey(ds, ids[:2], refs[:2]))
    pred, sigs, xents, real = tp.propagate_survey_device(ds, ids, refs)
    assert real == len(ids) and sigs is None and xents is None
    assert pred.dtype == torch.int8 and pred.shape == (len(ids), T, ds.geo.nh)
