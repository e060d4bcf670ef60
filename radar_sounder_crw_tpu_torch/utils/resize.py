"""Resizing with PyTorch's `F.interpolate` semantics: nearest on host numpy
arrays (seed columns and class maps), bilinear with align_corners=True on
NCHW tensors (the UNet's upsampling).

`paths[route]` counts the `resize_nearest` calls by the route their
columns took: "repeat" (each source column a whole number of times in
turn, as a patch map's 16-pixel columns) or "take" (any other index).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

paths = {"repeat": 0, "take": 0}


@functools.lru_cache(maxsize=1024)
def _nearest_idx(out_size: int, in_size: int) -> np.ndarray:
    # interpolate computes src = floorf(dst * scale) with scale = in/out in
    # FLOAT32 arithmetic; the float rounding of the product is part of the
    # semantics, so the float32 computation is emulated bit for bit. The
    # array is shared by every call of the shape, so it is read-only.
    scale = np.float32(in_size) / np.float32(out_size)
    idx = np.floor(np.arange(out_size, dtype=np.float32) * scale).astype(np.int64)
    idx = np.minimum(idx, in_size - 1).astype(np.int32)
    idx.flags.writeable = False
    return idx


@functools.lru_cache(maxsize=1024)
def _whole_repeat(out_size: int, in_size: int) -> int:
    """k where the nearest index is each source index k times in turn
    (out_size = k * in_size and the float32 index agrees), else 0."""
    if in_size == 0 or out_size % in_size:
        return 0
    k = out_size // in_size
    same = np.array_equal(_nearest_idx(out_size, in_size), np.repeat(np.arange(in_size), k))
    return k if same else 0


def _resize_columns(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    k = _whole_repeat(out_size, x.shape[axis])
    if k:
        paths["repeat"] += 1
        return np.repeat(x, k, axis=axis)
    paths["take"] += 1
    return np.take(x, _nearest_idx(out_size, x.shape[axis]), axis=axis)


def resize_nearest(x: np.ndarray, out_hw: tuple[int, int], axes=(-2, -1)) -> np.ndarray:
    """Nearest resize of `x` along two axes to `out_hw`, in `x`'s dtype.

    The rows are one gather by the shape's cached index, of whole rows. The
    columns are one `np.repeat` where the index repeats each source column
    a whole number of times (decided once per shape), else one gather.
    Where the rows grow, the columns are resized first, on the fewer rows."""
    a0, a1 = axes
    x = np.asarray(x)
    rows = _nearest_idx(out_hw[0], x.shape[a0])
    if out_hw[0] < x.shape[a0]:
        return _resize_columns(np.take(x, rows, axis=a0), out_hw[1], a1)
    return np.take(_resize_columns(x, out_hw[1], a1), rows, axis=a0)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor's (H, W) to `out_hw`, corners
    aligned (radar_sounder_crw_tpu/utils/resize.py on NHWC)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)
