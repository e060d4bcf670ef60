"""Spans and traces.

`span` marks one layer of the port on a `torch.profiler` recording's
timeline and costs a flag read when no profiler runs. Each entry point
records a root span that holds its layers' spans: `crw.survey`
(`PropagationPipeline.propagate_survey`), `crw.seed` (`__call__`),
`crw.reseed` (`reseed`), `crw.step` (`CRWTrainer.train_step`) and
`crw.unet.step` (`UNetTrainer.train_step`); `crw.upload` marks each
host-to-device copy of input data. `profile_trace` records a
`torch.profiler` Chrome trace (`cli.train --profile_dir`), the spans
included.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` (a `crw.*` layer name) on the timeline
    of a running `torch.profiler` recording, and nothing otherwise.

    With no profiler running it returns one shared no-op context: it
    allocates, synchronises and records nothing. Under a profiler it is a
    FUNCTION-scope record function (`_RecordFunctionFast`): it lands on the
    kineto timeline, which the device's events share, and unlike
    `record_function` (a user annotation) it is not mirrored onto the
    device's timeline. A span never waits for the device and changes
    nothing of what runs; a caller's span holds the spans of its callees."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


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
