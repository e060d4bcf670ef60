"""Resizing with PyTorch's `F.interpolate` semantics: nearest on host numpy
arrays (seed columns and class maps are tiny), bilinear with
align_corners=True on NCHW tensors (the UNet's upsampling)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor's (H, W) to `out_hw`, corners
    aligned (radar_sounder_crw_tpu/utils/resize.py on NHWC)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)
