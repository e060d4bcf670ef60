"""The readers of the program's spans (portbench/spans.py and the metrics
encode_ms, backward_ms, pelt_ms, assemble_ms, frame_host_us): toy CPU runs
of the survey, seed and reseed mixes through the whole harness, the same
runs with the program's spans off (a program without them), and the
attribution of device events to spans on recorded events as the card's
profiler gives them."""

from __future__ import annotations

import argparse
import contextlib
import time

import pytest
import torch

from portbench import harness, run, spans
from portbench import trace as tr

from .conftest import toy_manifest

SEED = 2 ** 31 + 4321
NEW = ("encode_ms", "backward_ms", "pelt_ms", "assemble_ms", "frame_host_us")
HOST = {"pelt_ms": "crw.pelt", "assemble_ms": "crw.assemble.", "frame_host_us": "crw.frames"}
# the spans each toy cell records; the survey splices a correction only
# where PELT finds a change point early enough
SPLICE = "crw.assemble.splice"
EXPECTED = {
    "toy-miguel.survey": {"crw.encode", "crw.pelt", "crw.frames", "crw.assemble.to_pixels",
                          "crw.assemble.unflip", "crw.assemble.merge"},
    "toy-sharad.seed": {"crw.encode", "crw.pelt", "crw.frames"},
    "toy-miguel.reseed": {"crw.frames"},
    "toy-sharad.train": {"crw.encode", "crw.loss", "crw.backward", "crw.optimizer"},
}


def _traced(toy_root, monkeypatch, cell, program_spans=True):
    """(result line, Trace) of a traced toy run on the CPU."""
    captured = []

    class Recorded(tr.Trace):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(tr, "Trace", Recorded)
    if not program_spans:
        profiled = tr.profiled

        @contextlib.contextmanager
        def spans_off():
            with profiled() as prof:
                # the program reads this flag to decide whether to record
                torch.autograd.profiler._is_profiler_enabled = False
                yield prof

        monkeypatch.setattr(tr, "profiled", spans_off)
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=0.6, trace=1)
    r = run.run(args, manifest=toy_manifest(), roots=(toy_root, harness.HERE), allow_cpu=True,
                t_start=time.perf_counter())
    return r, captured[0]


def _as_on_the_card(trace, launches):
    """The same recording with one device interval and a launch count, as
    a card's run has them: the CPU trace itself holds no device event."""
    card = tr.Trace(trace.prof, trace.requests, trace.work, {"prop_launches": launches})
    card.device.append(tr.Interval("kernel", card.start_ns, card.start_ns + 1000))
    return card


def _read(trace, stem, toy_root):
    return harness.reader(f"{stem}.x", roots=(toy_root, harness.HERE))(trace, None)


@pytest.mark.parametrize("cell", ["toy-miguel.survey", "toy-sharad.seed", "toy-miguel.reseed"])
def test_span_readers_on_toy_cpu_runs(toy_root, monkeypatch, cell):
    r, trace = _traced(toy_root, monkeypatch, cell)
    assert r["correct"] and not r["metrics"], "a CPU run reads no per-layer metric"
    found = spans.of(trace)
    assert {s.name for s in found.spans} - {SPLICE} == EXPECTED[cell]
    assert all(trace.start_ns <= s.start_ns and s.end_ns <= trace.end_ns for s in found.spans)
    for stem in NEW:
        assert _read(trace, stem, toy_root) is None, stem
    card = _as_on_the_card(trace, launches=7)
    for stem in NEW:
        got = _read(card, stem, toy_root)
        if stem not in HOST or not any(s.name.startswith(HOST[stem]) for s in found.spans):
            assert got is None, stem  # the device stems: no event of a CPU trace is a kernel
            continue
        host = found.host_s(HOST[stem])
        want = 1e6 * host / 7 if stem == "frame_host_us" else 1e3 * host / trace.requests
        assert got == pytest.approx(want) and got > 0, stem


@pytest.mark.parametrize("cell", sorted(EXPECTED))
def test_no_program_spans_read_none(toy_root, monkeypatch, cell):
    r, trace = _traced(toy_root, monkeypatch, cell, program_spans=False)
    assert r["correct"]
    assert not spans.of(trace).spans
    card = _as_on_the_card(trace, launches=7)
    for stem in NEW:
        assert _read(card, stem, toy_root) is None, stem


# -- attribution on recorded events --------------------------------------------

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    """The KinetoEvent methods spans.py reads."""

    def __init__(self, name, kind, start, end, thread=1, corr=0, linked=0):
        self._v = dict(name=name, kind=kind, start=start, end=end, thread=thread, corr=corr,
                       linked=linked)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return CUDA if self._v["kind"] in ("kernel", "gpu_memcpy", "gpu_user_annotation") \
            else CPU

    def is_user_annotation(self):
        return self._v["kind"] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._v["start"]

    def duration_ns(self):
        return self._v["end"] - self._v["start"]

    def start_thread_id(self):
        return self._v["thread"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]


class FakeTrace:
    def __init__(self, events, lo, hi, busy):
        results = type("R", (), {"events": lambda self: events})()
        self.prof = type("P", (), {"profiler": type("Q", (), {"kineto_results": results})()})()
        self.start_ns, self.end_ns = lo, hi
        self.busy = busy
        self.busy_s = sum(b - a for a, b in busy) / 1e9


def test_device_events_belong_to_the_launching_threads_innermost_span():
    """Thread 1 encodes (an op launches a kernel), then backward hands its
    launches to thread 2, which has no span; a kernel linked to nothing goes
    by the spans open at its start; a custom kernel launched with no
    operator of its own links to the span itself; a copy after the spans
    belongs to none."""
    ev = [
        Event("pb.step", "user_annotation", 0, 1000, corr=1),
        Event("pb.step", "gpu_user_annotation", 35, 945, corr=1),
        Event("crw.encode", "cpu_op", 10, 300, corr=2),
        Event("aten::conv", "cpu_op", 20, 60, corr=3),
        Event("cudaLaunchKernel", "cuda_runtime", 30, 40, thread=99, corr=501, linked=3),
        Event("conv_kernel", "kernel", 35, 235, corr=501, linked=3),
        Event("crw.backward", "cpu_op", 310, 700, corr=4),
        Event("aten::conv_bwd", "cpu_op", 320, 340, thread=2, corr=5),
        Event("bwd_kernel", "kernel", 330, 630, corr=502, linked=5),
        Event("unlinked_kernel", "kernel", 640, 650, corr=505),
        Event("crw.frames", "cpu_op", 710, 800, corr=6),
        Event("custom_kernel", "kernel", 720, 760, corr=503, linked=6),
        Event("aten::copy_", "cpu_op", 900, 950, corr=7),
        Event("Memcpy DtoH", "gpu_memcpy", 905, 945, corr=504, linked=7),
        Event("crw.encode", "cpu_op", 2000, 2100, corr=8),  # after the slice
    ]
    busy = [(35, 235), (330, 630), (640, 650), (720, 760), (905, 945)]
    found = spans.Spans(FakeTrace(ev, 0, 1000, busy))
    assert [s.name for s in found.spans] == ["crw.encode", "crw.backward", "crw.frames",
                                             "crw.encode"]
    assert found.device_s == pytest.approx({"crw.encode": 200e-9, "crw.backward": 310e-9,
                                            "crw.frames": 40e-9, None: 40e-9})
    assert found.unlinked == 1
    assert found.host_s("crw.encode") == pytest.approx(290e-9)
    idle = found.idle_by_span(busy)
    assert idle == pytest.approx({"crw.encode": 90e-9, "crw.backward": 80e-9,
                                  "crw.frames": 50e-9, "none": 190e-9})
    assert sum(idle.values()) == pytest.approx(1000e-9 - sum(b - a for a, b in busy) / 1e9)


def test_innermost_span_of_nested_and_sequential_spans():
    s = [spans.Span("crw.a", 1, 0, 100), spans.Span("crw.b", 1, 10, 20),
         spans.Span("crw.c", 1, 30, 40), spans.Span("crw.d", 2, 50, 60)]
    q = [(15, 1), (25, 1), (35, 1), (55, 1), (55, 3), (55, None), (120, 1), (10, 1), (20, 1)]
    assert spans._innermost(s, q) == [1, 0, 2, 0, 3, 3, None, 1, 0]
