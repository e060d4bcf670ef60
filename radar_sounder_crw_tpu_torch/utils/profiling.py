"""Step timing and traces.

The roles of radar_sounder_crw_tpu/utils/profiling.py: `StepTimer` reads
the clock only after the step's outputs exist on the device (PyTorch
returns before a CUDA kernel finishes, so an unsynchronised clock measures
the enqueue), `time_fn` times a function with CUDA events when its result
lies on a CUDA device, and `profile_trace` records a `torch.profiler`
Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _synchronize(obj) -> bool:
    """Wait for every CUDA device holding a tensor of `obj`; True if any."""
    devices = {t.device for t in _tensors(obj) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return bool(devices)


class StepTimer:
    """Accumulates per-step wall times, each read after the step's outputs
    are complete on their device."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *sync_on):
        """Stop the clock once every tensor of `sync_on` is complete."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        _synchronize(sync_on)
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None
        return self.times[-1]

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def steps_per_sec(self) -> float:
        return 1.0 / self.mean if self.mean else 0.0


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """A torch.profiler trace of the block, written as
    `<logdir>/trace.json` (Chrome trace format); nothing when logdir is None."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_fn(fn, *args, warmup: int = 2, iters: int = 10):
    """(mean seconds per call, last result) of `fn(*args)`: CUDA events
    around the timed calls when the result lies on a CUDA device, the host
    clock otherwise."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
    if _synchronize(result):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            result = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, result
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args)
    return (time.perf_counter() - t0) / iters, result
