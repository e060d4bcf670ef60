"""Encoder checkpoints in the reference's `.pt` layout -> the port's modules.

The role of radar_sounder_crw_tpu/models/torch_import.py
(`load_torch_checkpoint`) together with the loader of
scripts/_common.py: a reference-trained encoder file is a torch
`state_dict` (or a pickled `nn.Module`, whose `state_dict()` is taken) under
the reference's names, which the port's encoders share, so it loads with
`load_state_dict(strict=True)`. Accepted besides:
  * the `module.` prefix `DataParallel` leaves on every key;
  * a file without BatchNorm buffers (running statistics,
    `num_batches_tracked`, which the JAX package's `export_state_dict` never
    writes): those come from the module as created, as the JAX CLIs fill a
    missing `batch_stats` collection from a fresh init.
A missing or unexpected parameter still fails the strict load.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..data.torch_pt import load_pt

_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def read_state_dict(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """The file's state_dict as CPU tensors, `module.` prefixes stripped."""
    obj = load_pt(path)
    if isinstance(obj, nn.Module):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise ValueError(f"{os.fspath(path)}: expected a state_dict, found {type(obj).__name__}")
    sd = {k: torch.as_tensor(v) for k, v in obj.items()}
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def load_torch_checkpoint(path: str | os.PathLike, model: nn.Module) -> nn.Module:
    """Load the encoder file at `path` into `model` (strict) and return it;
    BatchNorm buffers the file lacks keep the model's own values."""
    sd = read_state_dict(path)
    for name, buf in model.state_dict().items():
        if name not in sd and name.rsplit(".", 1)[-1] in _BN_BUFFERS:
            sd[name] = buf
    model.load_state_dict(sd, strict=True)
    return model
