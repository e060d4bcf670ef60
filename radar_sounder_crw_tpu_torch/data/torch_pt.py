"""`.pt` interchange: `load_pt` and `save_pt` through `torch.load` and
`torch.save`.

The roles of radar_sounder_crw_tpu/data/torch_pt.py, which reads and writes
the same zip layout without torch: a file either package writes loads on
the other. `load_pt` keeps torch's restricted unpickler
(`weights_only=True`): tensors, containers and scalars load, arbitrary
pickled objects do not, unless `RSCRW_ALLOW_UNSAFE_PT=1` permits full
unpickling of a trusted file, as on the JAX side.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["load_pt", "save_pt"]


def load_pt(path: str | os.PathLike):
    """Load a `.pt` file on the CPU: tensors come back as torch tensors,
    containers and scalars as written. Raises ValueError for a file that
    needs full unpickling unless RSCRW_ALLOW_UNSAFE_PT=1."""
    path = os.fspath(path)
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        if os.environ.get("RSCRW_ALLOW_UNSAFE_PT") != "1":
            raise ValueError(
                f"{path}: torch.load(weights_only=True) refused this file ({err}); set "
                f"RSCRW_ALLOW_UNSAFE_PT=1 to permit full unpickling of a TRUSTED file"
            ) from err
        return torch.load(path, map_location="cpu", weights_only=False)


def _to_torch(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, dict):
        return type(obj)((k, _to_torch(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v) for v in obj)
    return obj


def save_pt(path: str | os.PathLike, obj) -> None:
    """Write `obj` (tensors, numpy arrays, containers, scalars) as a torch
    zip-format `.pt`; numpy arrays become tensors of their own dtype (an
    int8 map stays int8)."""
    torch.save(_to_torch(obj), os.fspath(path))
