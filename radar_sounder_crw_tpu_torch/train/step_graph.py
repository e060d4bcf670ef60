"""k train steps as one device program: the port's `steps_per_dispatch`.

The JAX package scans k optimizer steps into one jitted program
(radar_sounder_crw_tpu/train/crw_trainer.py, `multi_step`, `multi_res`).
On the card the same is one CUDA graph: `StepGraph` runs `body` (k whole
steps that read static input buffers and write a static loss buffer) as one
graph replay. Its first call runs `body` eagerly on a side stream, as real
steps that also warm everything up (Adam's state, cuDNN's and cuBLAS's
workspaces, cached index tensors), then captures it; every later call
replays the capture. Elsewhere `body` runs eagerly, which is the same
arithmetic. A capture that fails raises and names the cause: nothing falls
back to eager steps on the card.

What a capture needs of the step, and the trainer provides: Adam with
`capturable=True`, autocast without its cast cache, activation
checkpointing that leaves the RNG state alone, no host synchronisation and
no upload inside the step, and NCCL for a mesh's collectives (gloo's cannot
be captured).
"""

from __future__ import annotations

from typing import Callable

import torch

replays = 0  # graph replays of every StepGraph in this process


class StepGraph:
    """`body()` as one CUDA graph replay on a CUDA `device` (after one eager
    warm-up call), eagerly on any other device."""

    def __init__(self, body: Callable[[], None], device: torch.device):
        self.body = body
        self.device = device
        self.graph = None

    def __call__(self) -> None:
        global replays
        if self.device.type != "cuda":
            self.body()
            return
        if self.graph is not None:
            self.graph.replay()
            replays += 1
            return
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.body()  # real steps, and the warm-up of the capture
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self.body()  # recorded, not run
        except Exception as e:
            raise RuntimeError(f"capturing the train steps in a CUDA graph failed: {e}") from e
        self.graph = graph
