"""The program's own spans in a traced slice: the `crw.*` spans that
radar_sounder_crw_tpu_torch records (`utils.profiling.span`) while a
torch.profiler recording runs, and the span each device event belongs to.

A device event (a kernel, copy or set) belongs to the innermost `crw.*`
span open, at the moment of its launch, on the thread that launched it;
a launch from a thread with no open `crw.*` span (the autograd engine's
device thread during a backward) belongs to the innermost `crw.*` span
open on any thread at that moment. The launching thread is that of the
host operator or span the device event is linked to
(`linked_correlation_id`); the moment is the start of the runtime call
that shares the device event's correlation id, else the operator's
start. A device event linked to nothing was launched with no operator or
`crw.*` span open on its thread: it goes by the spans open on any thread
at its own start. A trace of a program without these spans reads as none.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

PREFIX = "crw."


@dataclasses.dataclass
class Span:
    name: str
    thread: int
    start_ns: int
    end_ns: int


class Spans:
    """The `crw.*` spans of a traced slice and its device events by span."""

    def __init__(self, trace):
        cuda = torch.autograd.DeviceType.CUDA
        lo, hi = trace.start_ns, trace.end_ns
        events = trace.prof.profiler.kineto_results.events()
        self.spans: list[Span] = []
        host, on_device = [], []
        for e in events:
            (on_device if e.device_type() == cuda else host).append(e)
            if e.name().startswith(PREFIX) and e.device_type() != cuda:
                start = e.start_ns()
                self.spans.append(Span(e.name(), e.start_thread_id(), start,
                                       start + e.duration_ns()))
        # the device's copies of user annotations (record_function spans,
        # mirrored over their kernels) are not work
        mirrored = {e.name() for e in host if e.is_user_annotation()}
        device = []  # (start, end, linked id, correlation id) inside the slice
        for e in on_device:
            if e.is_user_annotation() or e.name() in mirrored:
                continue
            start = e.start_ns()
            end = start + e.duration_ns()
            if end > lo and start < hi:
                device.append((max(start, lo), min(end, hi), e.linked_correlation_id(),
                               e.correlation_id()))
        linked = {d[2] for d in device}
        correlated = {d[3] for d in device}
        # the operators device events link to (linked id 0: called from the
        # program), and the runtime calls that launched them (linked to an
        # operator, sharing the device event's correlation id)
        ops, runtime = {}, {}
        for e in host:
            if e.linked_correlation_id() == 0:
                if e.correlation_id() in linked:
                    ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            elif e.correlation_id() in correlated:
                runtime[e.correlation_id()] = e.start_ns()
        queries = []
        for start, end, link, corr in device:
            thread, t = ops.get(link, (None, start))
            queries.append((runtime.get(corr, t), thread))
        owner = _innermost(self.spans, queries)
        self.device_s: dict[str, float] = {}  # device seconds by owning span name
        self.unlinked = 0  # device events linked to no host operator
        for (start, end, _, _), (t, thread), k in zip(device, queries, owner):
            self.unlinked += thread is None
            name = self.spans[k].name if k is not None else None
            self.device_s[name] = self.device_s.get(name, 0.0) + (end - start) / 1e9
        self.window = (lo, hi)

    def host_s(self, prefix: str) -> float | None:
        """Seconds of the slice inside spans whose name starts with `prefix`
        (their union, on any thread); None where there is no such span."""
        lo, hi = self.window
        ivs = sorted((max(s.start_ns, lo), min(s.end_ns, hi)) for s in self.spans
                     if s.name.startswith(prefix) and s.end_ns > lo and s.start_ns < hi)
        if not ivs:
            return None
        total, (a, b) = 0, ivs[0]
        for c, d in ivs[1:]:
            if c > b:
                total, a = total + b - a, c
            b = max(b, d)
        return (total + b - a) / 1e9

    def idle_by_span(self, busy: list[tuple[int, int]]) -> dict:
        """The slice's device idle seconds by the innermost `crw.*` span
        open (on any thread) while the device waited, "none" outside every
        span; busy: the device's merged busy intervals (trace.Trace.busy)."""
        lo, hi = self.window
        edges = [(lo, lo), *busy, (hi, hi)]
        gaps = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
        cuts = sorted({lo, hi, *(t for s in self.spans for t in (s.start_ns, s.end_ns)
                                 if lo < t < hi)})
        pieces = list(zip(cuts, cuts[1:]))  # no span opens or closes inside one
        owner = _innermost(self.spans, [((a + b) // 2, None) for a, b in pieces])
        out: dict = {}
        i = 0
        for (a, b), k in zip(pieces, owner):
            while i < len(gaps) and gaps[i][1] <= a:
                i += 1
            j, idle = i, 0
            while j < len(gaps) and gaps[j][0] < b:
                idle += min(b, gaps[j][1]) - max(a, gaps[j][0])
                j += 1
            if idle:
                name = self.spans[k].name if k is not None else "none"
                out[name] = out.get(name, 0.0) + idle / 1e9
        return out


def _innermost(spans: list[Span], queries: list) -> list:
    """For each (time, thread) query, the index in `spans` of the innermost
    span open at that time on that thread, else (or for thread None) of the
    innermost open on any thread (the latest started); None where none is.
    One sweep over the spans' edges and the queries in time order; spans of
    one thread nest."""
    edges = []
    for k, s in enumerate(spans):
        edges.append((s.start_ns, 1, k))
        edges.append((s.end_ns, 0, k))
    edges.sort()
    order = sorted(range(len(queries)), key=lambda q: queries[q][0])
    stacks: dict = {}
    out: list = [None] * len(queries)
    i = 0
    for q in order:
        t, thread = queries[q]
        while i < len(edges) and edges[i][0] <= t:
            _, opening, k = edges[i]
            stack = stacks.setdefault(spans[k].thread, [])
            if opening:
                stack.append(k)
            elif stack and stack[-1] == k:
                stack.pop()
            elif k in stack:
                stack.remove(k)
            i += 1
        own = stacks.get(thread)
        if own:
            out[q] = own[-1]
        else:
            tops = [st[-1] for st in stacks.values() if st]
            out[q] = max(tops, key=lambda k: spans[k].start_ns) if tops else None
    return out


_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def of(trace) -> Spans:
    """The spans of `trace`, read once per trace."""
    if trace not in _CACHE:
        _CACHE[trace] = Spans(trace)
    return _CACHE[trace]


def host_seconds(trace, prefix: str) -> float | None:
    """Host seconds of the slice inside the spans `prefix`*; None where
    there is no such span, or where the slice ran nothing on the device:
    the benchmark reads a run on the card, and on the CPU a span's host
    time holds the work itself, not the host's share of it."""
    if trace.busy_s == 0:
        return None
    return of(trace).host_s(prefix)


def device_seconds(trace, name: str) -> float | None:
    """Device seconds of the events that belong to span `name`; None where
    no device event does."""
    return of(trace).device_s.get(name)
