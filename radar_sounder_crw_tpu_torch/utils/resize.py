"""Nearest resize with PyTorch `F.interpolate(mode='nearest')` index semantics,
on host numpy arrays (seed columns and class maps are tiny)."""

from __future__ import annotations

import numpy as np


def _nearest_idx(out_size: int, in_size: int) -> np.ndarray:
    # interpolate computes src = floorf(dst * scale) with scale = in/out in
    # FLOAT32 arithmetic; the float rounding of the product is part of the
    # semantics, so the float32 computation is emulated bit for bit
    scale = np.float32(in_size) / np.float32(out_size)
    idx = np.floor(np.arange(out_size, dtype=np.float32) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1).astype(np.int32)


def resize_nearest(x: np.ndarray, out_hw: tuple[int, int], axes=(-2, -1)) -> np.ndarray:
    """Nearest resize of `x` along two axes to `out_hw`."""
    a0, a1 = axes
    x = np.asarray(x)
    x = np.take(x, _nearest_idx(out_hw[0], x.shape[a0]), axis=a0)
    return np.take(x, _nearest_idx(out_hw[1], x.shape[a1]), axis=a1)
