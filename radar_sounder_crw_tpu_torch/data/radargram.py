"""Radargram loading and the window dataset (host numpy).

`RGWindows` holds one full radargram on the host and serves windows of
`length` frames as (T, N, h, w) float32 arrays; `ConcatWindows` chains
several such datasets with one item shape. `.pt` data products load through
`torch.load(..., weights_only=True)`.

A copy of radar_sounder_crw_tpu/data/radargram.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .patchify import GridGeometry, extract_window, window_geometry

# Column lengths of the 7 concatenated MCORDS3 ("Miguel") sub-radargrams
_MIGUEL_SPLITS = (9984, 6656, 9984, 20000, 16640, 32864, 8992)


def load_radargram(filepath: str) -> np.ndarray:
    """Load a 2-D radargram from a .npy, .npz or torch .pt file."""
    if filepath.endswith(".npy"):
        return np.asarray(np.load(filepath), dtype=np.float32)
    if filepath.endswith(".npz"):
        with np.load(filepath) as z:
            return np.asarray(z[z.files[0]], dtype=np.float32)
    if filepath.endswith(".pt"):
        t = torch.load(filepath, map_location="cpu", weights_only=True)
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{filepath}: expected a tensor, found {type(t).__name__}")
        return t.float().numpy()
    raise ValueError(f"Unsupported radargram format: {filepath}")


def trim_miguel(rg: np.ndarray, length: int, dim: tuple[int, int]) -> np.ndarray:
    """Trim each concatenated MCORDS3 sub-radargram to a multiple of w*length."""
    splits = np.asarray(_MIGUEL_SPLITS)
    starts = np.concatenate([[0], np.cumsum(splits)[:-1]])
    pieces = []
    for start, L in zip(starts, splits):
        nrgs = int(L // (dim[1] * length))
        pieces.append(rg[:, start : start + nrgs * (dim[1] * length)])
    return np.concatenate(pieces, axis=1)


class RGWindows:
    """Windowed view over one radargram.

    Args:
      source: path to a radargram file, or an (H, W) array.
      length: frames per window (T).
      dim: patch size (h, w).
      overlap: patch overlap (oh, ow).
      flip: reverse the trace axis before windowing.
      trim_miguel_splits: apply the MCORDS3 concatenation trim (set by the
        dataset registry).
    """

    def __init__(
        self,
        source,
        length: int = 10,
        dim: tuple[int, int] = (24, 24),
        overlap: tuple[int, int] = (0, 0),
        flip: bool = False,
        trim_miguel_splits: bool = False,
    ):
        if isinstance(source, (str, os.PathLike)):
            rg = load_radargram(str(source))
        else:
            rg = np.asarray(source, dtype=np.float32)
        if rg.ndim != 2:
            raise ValueError(f"radargram must be 2-D, got shape {rg.shape}")
        if trim_miguel_splits:
            rg = trim_miguel(rg, length, dim)
        if flip:
            rg = rg[:, ::-1]
        self.rg = np.ascontiguousarray(rg, dtype=np.float32)
        self.geo: GridGeometry = window_geometry(self.rg.shape, dim, overlap, length)
        if self.geo.nw <= 0:
            raise ValueError(
                f"radargram of width {self.rg.shape[1]} too narrow for "
                f"length={length}, w={dim[1]}, ow={overlap[1]}"
            )

    def __len__(self) -> int:
        return self.geo.nw

    def __getitem__(self, index: int) -> np.ndarray:
        """Window `index` as (T, N, h, w) float32."""
        return extract_window(self.rg, self.geo, index)

    def get_smaller_item(self, index: int, small_length: int) -> np.ndarray:
        """Shorter window starting at the same trace offset, (T', N, h, w)."""
        return extract_window(self.rg, self.geo, index, length=small_length)

    def non_overlapping_indices(self) -> range:
        """Stride-`length` item subset."""
        return range(0, len(self), self.geo.length)

    def batch(self, indices, length: int | None = None) -> np.ndarray:
        """Stack windows into a (B, T, N, h, w) batch."""
        return np.stack([extract_window(self.rg, self.geo, i, length) for i in indices])

    @property
    def item_shape(self) -> tuple[int, int, int, int]:
        g = self.geo
        return (g.length, g.nh, g.h, g.w)


class ConcatWindows:
    """Concatenation of several window datasets with identical item shapes."""

    def __init__(self, datasets: list):
        shapes = {tuple(d.item_shape) for d in datasets}
        if len(shapes) != 1:
            raise ValueError(f"item shapes differ across datasets: {shapes}")
        self.datasets = list(datasets)
        self.geo = datasets[0].geo
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    @property
    def item_shape(self):
        return self.datasets[0].item_shape

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int) -> np.ndarray:
        if index < 0 or index >= len(self):
            raise IndexError(index)
        d = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[d][index - int(self._offsets[d])]
