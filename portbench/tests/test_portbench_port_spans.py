"""The readers of the program's root spans and its upload span
(port_idle_share, upload_ms; portbench/spans.py): on recorded events as
the card's profiler gives them, and on toy CPU runs of the survey, seed,
reseed and train mixes through the whole harness, with the program's
spans on and off."""

from __future__ import annotations

import pytest

from portbench import harness, spans

from .test_portbench_spans import EXPECTED, SPLICE, Event, FakeTrace, _as_on_the_card, _traced

ROOTS = {
    "toy-miguel.survey": {"crw.survey", "crw.upload"},
    "toy-sharad.seed": {"crw.seed", "crw.upload"},
    "toy-miguel.reseed": {"crw.reseed"},
    "toy-sharad.train": {"crw.step"},
}
STEMS = ("port_idle_share", "upload_ms")


class Slice(FakeTrace):
    def __init__(self, events, lo, hi, busy, requests=1):
        super().__init__(events, lo, hi, busy)
        self.window_s = (hi - lo) / 1e9
        self.requests = requests


def _reader(stem, roots=(harness.HERE,)):
    return harness.reader(f"{stem}.x", roots=roots)


def test_port_idle_share_counts_nested_and_other_thread_spans_not_none(capsys):
    """A root on thread 1 holds a leaf; a span of thread 2 opens inside the
    root and one after it. Idle: 0-200, 250-400, 500-1000 of 0-1000."""
    ev = [
        Event("crw.seed", "cpu_op", 100, 900, corr=1),
        Event("crw.encode", "cpu_op", 150, 300, corr=2),
        Event("crw.unet.gather", "cpu_op", 600, 700, thread=2, corr=3),
        Event("crw.pelt", "cpu_op", 920, 980, thread=2, corr=4),
    ]
    busy = [(200, 250), (400, 500)]
    trace = Slice(ev, 0, 1000, busy)
    idle = spans.of(trace).idle_by_span(busy)
    assert idle == pytest.approx({"none": 140e-9, "crw.seed": 450e-9, "crw.encode": 100e-9,
                                  "crw.unet.gather": 100e-9, "crw.pelt": 60e-9})
    got = _reader("port_idle_share")(trace, None)
    assert got == pytest.approx(100 * 710 / 1000)
    idle_share = _reader("idle_share")(trace, None)
    assert 0 <= got <= idle_share == pytest.approx(85.0)
    line = capsys.readouterr().err.strip().splitlines()
    assert len(line) == 1 and "crw.seed 0.000000" in line[0] and "none 0.000000" in line[0]
    assert "unlinked device events 0" in line[0]


def test_port_idle_share_reads_none_without_spans_or_device_work():
    assert _reader("port_idle_share")(Slice([], 0, 1000, [(0, 10)]), None) is None
    ev = [Event("crw.seed", "cpu_op", 100, 900, corr=1)]
    assert _reader("port_idle_share")(Slice(ev, 0, 1000, []), None) is None


def test_upload_ms_reads_a_linked_host_to_device_copy():
    ev = [
        Event("crw.seed", "cpu_op", 0, 500, corr=1),
        Event("crw.upload", "cpu_op", 10, 100, corr=2),
        Event("aten::copy_", "cpu_op", 20, 90, corr=3),
        Event("cudaMemcpyAsync", "cuda_runtime", 25, 85, corr=501, linked=3),
        Event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 30, 80, corr=501, linked=3),
        Event("crw.encode", "cpu_op", 110, 300, corr=4),
        Event("aten::conv", "cpu_op", 120, 130, corr=5),
        Event("conv_kernel", "kernel", 125, 280, corr=502, linked=5),
    ]
    trace = Slice(ev, 0, 1000, [(30, 80), (125, 280)], requests=2)
    found = spans.of(trace)
    assert found.device_s == pytest.approx({"crw.upload": 50e-9, "crw.encode": 155e-9})
    assert _reader("upload_ms")(trace, None) == pytest.approx(1e3 * 50e-9 / 2)
    bare = Slice([e for e in ev if e.name() != "crw.upload"], 0, 1000, trace.busy, requests=2)
    assert _reader("upload_ms")(bare, None) is None  # a program without the span


def _step_events(root):
    """A step's spans and launches (as the attribution test's), with or
    without an outer root span on the launching thread."""
    ev = [
        Event("crw.encode", "cpu_op", 10, 300, corr=2),
        Event("aten::conv", "cpu_op", 20, 60, corr=3),
        Event("cudaLaunchKernel", "cuda_runtime", 30, 40, thread=99, corr=501, linked=3),
        Event("conv_kernel", "kernel", 35, 235, corr=501, linked=3),
        Event("crw.backward", "cpu_op", 310, 700, corr=4),
        Event("aten::conv_bwd", "cpu_op", 320, 340, thread=2, corr=5),
        Event("bwd_kernel", "kernel", 330, 630, corr=502, linked=5),
        Event("unlinked_kernel", "kernel", 640, 650, corr=505),
        Event("crw.optimizer", "cpu_op", 710, 800, corr=6),
        Event("aten::add_", "cpu_op", 720, 730, corr=7),
        Event("adam_kernel", "kernel", 725, 760, corr=503, linked=7),
        Event("aten::copy_", "cpu_op", 900, 950, corr=8),
        Event("Memcpy DtoH", "gpu_memcpy", 905, 945, corr=504, linked=8),
    ]
    if root:
        ev.insert(0, Event("crw.step", "cpu_op", 5, 990, corr=1))
    return ev


def test_an_outer_root_leaves_every_inner_span_unchanged():
    busy = [(35, 235), (330, 630), (640, 650), (725, 760), (905, 945)]
    bare = spans.of(Slice(_step_events(False), 0, 1000, busy))
    rooted = spans.of(Slice(_step_events(True), 0, 1000, busy))
    inner = ("crw.encode", "crw.backward", "crw.optimizer")
    for name in inner:
        assert rooted.device_s[name] == bare.device_s[name], name
        assert rooted.host_s(name) == bare.host_s(name), name
    # what belonged to no span now belongs to the root, and nothing else moved
    assert bare.device_s[None] == pytest.approx(40e-9)
    assert rooted.device_s == pytest.approx({**{n: bare.device_s[n] for n in inner},
                                             "crw.step": 40e-9})
    idle_bare, idle_rooted = bare.idle_by_span(busy), rooted.idle_by_span(busy)
    for name in inner:
        assert idle_rooted[name] == pytest.approx(idle_bare[name]), name
    assert idle_rooted["crw.step"] + idle_rooted["none"] == pytest.approx(idle_bare["none"])
    assert idle_rooted["none"] == pytest.approx(15e-9)  # 0-5 and 990-1000


@pytest.mark.parametrize("cell", sorted(ROOTS))
def test_toy_runs_record_the_roots_and_the_upload(toy_root, monkeypatch, cell):
    r, trace = _traced(toy_root, monkeypatch, cell)
    assert r["correct"]
    found = spans.of(trace)
    assert {s.name for s in found.spans} - {SPLICE} == EXPECTED[cell] | ROOTS[cell]
    roots = [s for s in found.spans if s.name in ROOTS[cell] - {"crw.upload"}]
    assert len(roots) >= trace.requests
    for s in found.spans:  # every span but the host assembly's lies inside a root
        if s.name.startswith("crw.assemble."):
            continue
        assert any(o.thread == s.thread and o.start_ns <= s.start_ns and s.end_ns <= o.end_ns
                   for o in roots), s.name
    for stem in STEMS:
        assert _read(trace, stem, toy_root) is None, stem  # a CPU run reads none
    card = _as_on_the_card(trace, launches=7)
    share = _read(card, "port_idle_share", toy_root)
    assert 0 < share <= _read(card, "idle_share", toy_root)
    assert _read(card, "upload_ms", toy_root) is None  # no device event of a CPU trace


@pytest.mark.parametrize("cell", sorted(ROOTS))
def test_toy_runs_without_program_spans_read_none(toy_root, monkeypatch, cell):
    r, trace = _traced(toy_root, monkeypatch, cell, program_spans=False)
    card = _as_on_the_card(trace, launches=7)
    for stem in STEMS:
        assert _read(card, stem, toy_root) is None, stem


def _read(trace, stem, toy_root):
    return _reader(stem, roots=(toy_root, harness.HERE))(trace, None)
