"""The traced slice of a window: torch.profiler over the device and the
host, reduced to what the per-layer readers take.

Device intervals are the kernels, copies and sets the CUDA activity
records; `busy_s` is the length of their union, so overlapping work on
several streams counts once. The harness's own spans (record_function
names starting with "pb.") label the idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools

import torch

SPAN_PREFIX = "pb."


def span(name: str):
    """A harness span around a call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class Interval:
    name: str
    start_ns: int
    end_ns: int


class Trace:
    """A profiled slice: its wall length, device intervals and spans."""

    def __init__(self, prof, requests: int, work: dict, counters: dict):
        self.prof = prof
        self.requests = requests
        self.work = work  # the entry's counts over the slice (operations, bounds, ...)
        self.counters = counters  # program counters' increase over the slice
        self.device: list[Interval] = []
        self.spans: list[Interval] = []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            iv = Interval(e.name(), start, start + e.duration_ns())
            if e.name().startswith(SPAN_PREFIX):
                # a span is also mirrored onto the device's timeline as an
                # annotation over its kernels: only the host's copy is kept
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    self.spans.append(iv)
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                self.device.append(iv)
        win = [s for s in self.spans if s.name == SPAN_PREFIX + "window"]
        if len(win) != 1:
            raise RuntimeError(f"expected one window span in the trace, found {len(win)}")
        self.start_ns, self.end_ns = win[0].start_ns, win[0].end_ns
        self.window_s = (self.end_ns - self.start_ns) / 1e9
        self.device = sorted(
            (Interval(iv.name, max(iv.start_ns, self.start_ns), min(iv.end_ns, self.end_ns))
             for iv in self.device if iv.end_ns > self.start_ns and iv.start_ns < self.end_ns),
            key=lambda iv: iv.start_ns)

    @functools.cached_property
    def busy(self) -> list[tuple[int, int]]:
        """The union of the device intervals, merged, in order."""
        out: list[list[int]] = []
        for iv in self.device:
            if out and iv.start_ns <= out[-1][1]:
                out[-1][1] = max(out[-1][1], iv.end_ns)
            else:
                out.append([iv.start_ns, iv.end_ns])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernel_seconds(self, match) -> float:
        return sum(iv.end_ns - iv.start_ns for iv in self.device if match(iv.name)) / 1e9

    @functools.cached_property
    def op_device_seconds(self) -> dict:
        """Device seconds under each host operator, children included, by name."""
        out = {}
        for avg in self.prof.key_averages():
            t = getattr(avg, "device_time_total", None)
            if t is None:
                t = avg.cuda_time_total
            out[avg.key] = out.get(avg.key, 0.0) + t / 1e6
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for iv in self.device:
            by_name[iv.name] = by_name.get(iv.name, 0.0) + (iv.end_ns - iv.start_ns) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = {}
        busy = [(self.start_ns, self.start_ns), *self.busy, (self.end_ns, self.end_ns)]
        spans = sorted(self.spans, key=lambda s: s.start_ns)
        starts = [s.start_ns for s in spans]
        for (_, a), (b, _) in zip(busy, busy[1:]):
            if b <= a:
                continue
            mid = (a + b) // 2
            # spans are sequential requests with a few nested calls: the
            # innermost span holding `mid` starts among the last few before it
            k = bisect.bisect_right(starts, mid)
            inner = [s for s in spans[max(0, k - 8):k] if mid < s.end_ns]
            label = min(inner, key=lambda s: s.end_ns - s.start_ns).name if inner else "none"
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}


@contextlib.contextmanager
def profiled():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
