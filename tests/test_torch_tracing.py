"""The port's spans (`utils.profiling.span`) on the CPU: a shared no-op with
no profiler running; under `torch.profiler` the `crw.*` spans of the
seed->map call (one `crw.frames` a propagation call on every route), the
survey, the reseed, the CRW step and the host assembly, FUNCTION-scope
(not user annotations, so not mirrored onto a device's timeline), each
entry point's inside its root span (`crw.survey`, `crw.seed`,
`crw.reseed`, `crw.step`) and nested in the caller's span; and the same
outputs with the profiler on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from radar_sounder_crw_tpu_torch.data import (
    RGWindows,
    extract_window,
    synthetic_radargram,
    window_geometry,
)
from radar_sounder_crw_tpu_torch.infer import (
    PropagationPipeline,
    integrate_bidirectional,
    integrate_flat_mcords3,
    reverse_unfold_flip,
    splice_correction,
)
from radar_sounder_crw_tpu_torch.models import create_model
from radar_sounder_crw_tpu_torch.ops import labelprop
from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig
from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer
from radar_sounder_crw_tpu_torch.utils import span
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

T, NCLS = 8, 4
LP = LabelPropConfig(cxt_size=4, radius=4, temperature=0.05, knn=5)


def _events(prof):
    """(name, start, end, user annotation) of every host event, in start order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.is_user_annotation())
                   for e in prof.profiler.kineto_results.events()), key=lambda e: e[1])


def _crw(prof):
    return [e for e in _events(prof) if e[0].startswith("crw.")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _root_holds(prof, root, leaves):
    """The one `root` span of the recording, and its spans `leaves` (each
    once, in this order), all nested inside it."""
    spans = _crw(prof)
    roots = [e for e in spans if e[0] == root]
    assert len(roots) == 1, [e[0] for e in spans]
    held = [e for e in spans if e[0] in leaves]
    assert [e[0] for e in held] == list(leaves)
    for e in held:
        assert _inside(e, roots[0]), e[0]
    return roots[0], held


@pytest.fixture(scope="module")
def window():
    rg, seg = synthetic_radargram(H=128, W=256, nclasses=NCLS, seed=21, change_point=0.5)
    geo = window_geometry(rg.shape, (16, 16), (8, 0), T)
    return extract_window(rg, geo, 0), seg[: geo.rg_h(), : geo.w]


@pytest.fixture(scope="module")
def pipe():
    model = create_model(1, False, device="cpu", seed=3)
    return PropagationPipeline(model, LP, NCLS, device="cpu")


def test_span_without_a_profiler_is_one_shared_no_op():
    a, b = span("crw.a"), span("crw.b")
    assert a is b
    with a:  # entered before the recording starts: nothing to record
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(4).sum()
    assert not _crw(prof)
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("crw.a") is not a


def test_seed_call_spans_nest_in_the_caller(window, pipe):
    seq, seg_ref = window
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            pipe(seq, seg_ref, detect_change=True)
    caller = next(e for e in _events(prof) if e[0] == "caller")
    spans = _crw(prof)
    assert [e[0] for e in spans] == ["crw.seed", "crw.upload", "crw.encode", "crw.frames",
                                     "crw.pelt"]
    for name, start, end, user in spans:
        assert not user, name
        assert caller[1] <= start and end <= caller[2], name
    _root_holds(prof, "crw.seed", ["crw.upload", "crw.encode", "crw.frames", "crw.pelt"])


@pytest.mark.parametrize("kernel", ["torch", "cuda", "cuda_seq"])
def test_one_frames_span_a_propagation_call(monkeypatch, kernel):
    """`crw.frames` encloses the whole propagation call on every route, once
    a call and never nested: the plain route, the per-frame route over two
    radargrams, the whole-sequence route (device check lifted: the kernels'
    wrappers run their twins on CPU tensors)."""
    monkeypatch.setattr(labelprop, "resolve_kernel", lambda kernel, device: kernel)
    rng = np.random.default_rng(1)
    emb = torch.nn.functional.normalize(torch.as_tensor(rng.standard_normal((2, T, 6, 8)),
                                                        dtype=torch.float32), dim=-1)
    seeds = torch.eye(NCLS)[rng.integers(0, NCLS, (2, 6))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        labelprop.propagate_labels_batched(emb, seeds, LP, kernel=kernel, device="cpu")
    assert [e[0] for e in _crw(prof)] == ["crw.frames"]


def test_train_step_spans_in_order():
    rg, _ = synthetic_radargram(H=40, W=300, seed=7)
    trainer = CRWTrainer(CRWTrainConfig(model=0, batch_size=2, seq_length=4), device="cpu")
    geo = window_geometry(rg.shape, (16, 16), (8, 0), 4)
    batch = np.stack([extract_window(rg, geo, i) for i in (0, 3)])
    trainer.init_state(batch.shape[1:])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch)
    spans = _crw(prof)
    assert [e[0] for e in spans] == ["crw.step", "crw.upload", "crw.encode", "crw.loss",
                                     "crw.backward", "crw.optimizer"]
    _, phases = _root_holds(prof, "crw.step", ["crw.encode", "crw.loss", "crw.backward",
                                               "crw.optimizer"])
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:])), "phases overlap"
    assert not any(e[3] for e in spans)


@pytest.fixture(scope="module")
def survey():
    rg, seg = synthetic_radargram(H=64, W=520, nclasses=NCLS, seed=5, change_point=0.5)
    ds = RGWindows(rg, length=T, dim=(16, 16), overlap=(8, 0))
    rg_len = ds.geo.rg_len()
    ids = list(range(0, len(ds) - T + 1, T))[:2]
    refs = [seg[: ds.geo.rg_h(), rg_len * k: rg_len * k + 16] for k in range(len(ids))]
    return ds, ids, refs


def test_survey_spans_nest_in_one_root(survey):
    """A survey call's encode, frame loop and PELT lie inside one
    `crw.survey`, the radargram's upload too on its first call; a second
    call on the same radargram finds the upload memoized."""
    ds, ids, refs = survey
    model = create_model(1, False, device="cpu", seed=3)
    fresh = PropagationPipeline(model, LP, NCLS, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fresh.propagate_survey(ds, ids, refs, detect_change=True)
    _root_holds(prof, "crw.survey", ["crw.upload", "crw.encode", "crw.frames"]
                + ["crw.pelt"] * len(ids))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fresh.propagate_survey(ds, ids, refs, use_last=True)
    _root_holds(prof, "crw.survey", ["crw.encode", "crw.frames"])
    assert "crw.upload" not in [e[0] for e in _crw(prof)]


def test_reseed_spans_nest_in_one_root(window, pipe):
    seq, seg_ref = window
    pipe(seq, seg_ref, detect_change=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.reseed(seg_ref, 3, bucket=4)
    _root_holds(prof, "crw.reseed", ["crw.frames"])
    assert [e[0] for e in _crw(prof)] == ["crw.reseed", "crw.frames"]


def test_assembly_spans(pipe):
    rng = np.random.default_rng(0)
    pred = rng.integers(0, NCLS, (6, 8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        px = pipe.prediction_to_pixels(pred, (48, 64))
        px = splice_correction(px, pred[:, :2], 16)
        rev = reverse_unfold_flip(np.concatenate([px, px], axis=1), 64)
        integrate_flat_mcords3(px.ravel(), rev[:, :64])
        integrate_bidirectional(px, rev[:, 64:], "mcords1")
    assert [e[0] for e in _crw(prof)] == [
        "crw.assemble.to_pixels", "crw.assemble.splice", "crw.assemble.unflip",
        "crw.assemble.merge", "crw.assemble.merge"]


def _outputs(window, pipe, survey):
    seq, seg_ref = window
    res = pipe(seq, seg_ref, detect_change=True)
    reseeded = pipe.reseed(seg_ref, 2, bucket=4).prediction
    lines = pipe.propagate_survey(*survey, detect_change=True)
    rg, _ = synthetic_radargram(H=40, W=300, seed=7)
    trainer = CRWTrainer(CRWTrainConfig(model=0, batch_size=2, seq_length=4), device="cpu")
    geo = window_geometry(rg.shape, (16, 16), (8, 0), 4)
    batch = np.stack([extract_window(rg, geo, i) for i in (1, 5)])
    trainer.init_state(batch.shape[1:])
    return res, reseeded, lines, trainer.train_step(batch)


def test_outputs_equal_with_the_profiler_on_and_off(window, pipe, survey):
    """A seed call, a reseed, a survey call and a CRW step."""
    off, reseed_off, (lines_off, change_off), loss_off = _outputs(window, pipe, survey)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on, reseed_on, (lines_on, change_on), loss_on = _outputs(window, pipe, survey)
    assert {"crw.seed", "crw.reseed", "crw.survey", "crw.step"} <= {e[0] for e in _crw(prof)}
    np.testing.assert_array_equal(on.prediction, off.prediction)
    np.testing.assert_array_equal(on.xent, off.xent)
    assert on.change_idx == off.change_idx
    np.testing.assert_array_equal(reseed_on, reseed_off)
    np.testing.assert_array_equal(lines_on, lines_off)
    assert change_on == change_off
    assert torch.equal(loss_on, loss_off)
