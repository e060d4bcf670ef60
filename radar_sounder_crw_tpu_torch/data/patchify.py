"""Patch-grid geometry and windowing for radargrams (host numpy).

A radargram is a single-channel 2-D array (H x W): rows = fast-time (depth),
columns = traces along the flight line. It is tiled into a grid of
overlapping (h, w) patches; a *frame* is one vertical column of N patches,
and an inference item is a window of `length` consecutive frames, shaped
(T, N, h, w).

    nh  = (H - oh) // (h - oh)            # patches per column
    pxw = length * w - ow * (length - 1)  # item width in pixels
    nw  = (W - pxw) // (w - ow) + 1       # number of start positions
    pxh = nh * h - oh * (nh - 1)          # used height in pixels

A copy of radar_sounder_crw_tpu/data/patchify.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Patch-grid geometry for one radargram + windowing config."""

    H: int
    W: int
    h: int
    w: int
    oh: int
    ow: int
    length: int

    @property
    def nh(self) -> int:
        """Patches per frame (vertical)."""
        return (self.H - self.oh) // (self.h - self.oh)

    @property
    def pxw(self) -> int:
        """Item width in pixels."""
        return self.length * self.w - self.ow * (self.length - 1)

    @property
    def nw(self) -> int:
        """Number of window start positions."""
        return (self.W - self.pxw) // (self.w - self.ow) + 1

    @property
    def pxh(self) -> int:
        """Used height in pixels."""
        return self.nh * self.h - self.oh * (self.nh - 1)

    @property
    def num_items(self) -> int:
        return self.nw

    def col_start(self, index: int) -> int:
        """First pixel column of window `index`."""
        return (self.w - self.ow) * index

    def item_width(self, length: int | None = None) -> int:
        """Pixel width of a window of `length` frames (default self.length)."""
        length = self.length if length is None else length
        return length * self.w - self.ow * (length - 1)

    def num_windows(self, length: int | None = None, W: int | None = None) -> int:
        """Valid window start positions for `length` frames over a trace
        axis of `W` pixels (defaults self.length, self.W: then equal to nw).
        Shorter correction windows are bounds-checked against this."""
        W = self.W if W is None else W
        return (W - self.item_width(length)) // (self.w - self.ow) + 1

    def rg_len(self) -> int:
        """Rendered pixel length of one item: T*(w-ow)+ow."""
        return self.length * (self.w - self.ow) + self.ow

    def rg_h(self) -> int:
        """Rendered pixel height: N*(h-oh)+oh."""
        return self.nh * (self.h - self.oh) + self.oh


def window_geometry(shape, dim, overlap, length) -> GridGeometry:
    H, W = shape
    h, w = dim
    oh, ow = overlap
    return GridGeometry(H=H, W=W, h=h, w=w, oh=oh, ow=ow, length=length)


def unfold2d(x: np.ndarray, size: tuple[int, int], step: tuple[int, int]) -> np.ndarray:
    """Strided grid of 2-D patches as a zero-copy view: (H, W) -> (nh, nw, sh, sw)."""
    sh, sw = size
    th, tw = step
    H, W = x.shape
    nh = (H - sh) // th + 1
    nw = (W - sw) // tw + 1
    s0, s1 = x.strides
    return np.lib.stride_tricks.as_strided(
        x,
        shape=(nh, nw, sh, sw),
        strides=(s0 * th, s1 * tw, s0, s1),
        writeable=False,
    )


def extract_window(
    rg: np.ndarray, geo: GridGeometry, index: int, length: int | None = None
) -> np.ndarray:
    """Slice window `index` out of radargram `rg` and patchify to (T, N, h, w)."""
    length = geo.length if length is None else length
    pxw = geo.item_width(length)
    c0 = geo.col_start(index)
    if index < 0 or c0 + pxw > geo.W:
        raise IndexError(
            f"window index {index} out of range for length={length} "
            f"(needs columns [{c0}, {c0 + pxw}) of {geo.W})"
        )
    item = rg[: geo.pxh, c0 : c0 + pxw]
    grid = unfold2d(item, (geo.h, geo.w), (geo.h - geo.oh, geo.w - geo.ow))
    # (nh, T, h, w) -> (T, nh, h, w)
    return np.ascontiguousarray(np.transpose(grid, (1, 0, 2, 3))).astype(np.float32)
