"""Training checkpoints (save AND resume) with `torch.save`, and the encoder
export in the reference's `.pt` layout.

The roles of radar_sounder_crw_tpu/train/checkpoint.py, without orbax: one
directory a step, `<directory>/<step>/state.pt`, holding what a trainer's
`state_dict()` gives (the model with its buffers, Adam's state and `step`),
read back with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

import os
import re
import shutil

import torch
from torch import nn

from ..data.torch_pt import save_pt

_STATE = "state.pt"


class CheckpointManager:
    """Keeps the newest `max_to_keep` step directories under `directory`."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if re.fullmatch(r"\d+", name)
            and os.path.exists(os.path.join(self.directory, name, _STATE))
        )

    def save(self, step: int, state: dict):
        """Write `state` as step `step` (the file appears whole or not at
        all), then drop the oldest steps beyond max_to_keep."""
        step_dir = os.path.join(self.directory, str(int(step)))
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, _STATE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(step_dir, _STATE))
        for old in self.steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, map_location="cpu") -> dict:
        """The state saved at `step` (default the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, str(int(step)), _STATE)
        return torch.load(path, map_location=map_location, weights_only=True)

    def close(self):
        """Nothing is held open between calls; kept for the JAX API."""


def save_encoder_torch(model_or_state_dict, path: str | os.PathLike):
    """Write an encoder's state_dict (reference names, CPU tensors) as the
    `.pt` every evaluation entry point loads (data/torch_pt.save_pt)."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(os.fspath(path))), exist_ok=True)
    save_pt(path, sd)
