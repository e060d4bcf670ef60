"""Device-resident windowing: gather inference windows on the device.

The radargram is uploaded once; each batch of windows is then two index
gathers (columns, then rows) driven by a small (B,) index array. The gather
is the host geometry (`GridGeometry`), so a gathered window is bit-identical
to `extract_window` of the same index. Indices given as host arrays are
bounds-checked before the gather: an out-of-range index raises instead of
reading a neighbouring column or padding.

Follows radar_sounder_crw_tpu/data/device_windows.py.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import torch

from .patchify import GridGeometry


def window_index_arrays(geo: GridGeometry, length: int | None = None):
    """(row_idx (N*h,), col_rel (T*w,)) int32 gather indices for one window:
    patch n covers rows n*(h-oh) .. +h; frame t of a window starting at
    pixel column c0 covers c0 + t*(w-ow) .. +w."""
    T = geo.length if length is None else length
    row_idx = (
        np.arange(geo.nh)[:, None] * (geo.h - geo.oh) + np.arange(geo.h)[None, :]
    ).reshape(-1)
    col_rel = (
        np.arange(T)[:, None] * (geo.w - geo.ow) + np.arange(geo.w)[None, :]
    ).reshape(-1)
    return row_idx.astype(np.int32), col_rel.astype(np.int32)


@lru_cache(maxsize=64)
def _window_index_tensors(geo: GridGeometry, T: int, device: torch.device):
    """`window_index_arrays` as int64 tensors on `device`, uploaded once (a
    CUDA graph that captures a gather can upload nothing)."""
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in window_index_arrays(geo, T))


def _checked_host_indices(indices, stacked: bool, geo: GridGeometry, T: int, rg_shape):
    idx = np.asarray(indices)
    if stacked:
        if idx.ndim != 2 or idx.shape[-1] != 2:
            raise ValueError(
                f"stacked radargrams need (B, 2) (segment, window) index pairs, "
                f"got shape {idx.shape}"
            )
        # the widest segment's bound: a narrower segment's own bound is the
        # caller's contract (resident_source builds maps of in-range pairs)
        nw_max = geo.num_windows(T, W=rg_shape[2])
        if idx.size and (
            idx[:, 0].min() < 0
            or idx[:, 0].max() >= rg_shape[0]
            or idx[:, 1].min() < 0
            or idx[:, 1].max() >= nw_max
        ):
            raise IndexError(
                f"(segment, window) pair out of range "
                f"[0, {rg_shape[0]}) x [0, {nw_max}) in {idx!r}"
            )
    else:
        nw_t = geo.num_windows(T)
        if idx.size and (idx.min() < 0 or idx.max() >= nw_t):
            raise IndexError(
                f"window index out of range [0, {nw_t}) for length={T} in {idx!r}"
            )
    return idx


def gather_windows(rg: torch.Tensor, indices, geo: GridGeometry, length: int | None = None):
    """Resident radargram(s) + window indices -> (B, T, N, h, w), equal to
    `extract_window` per item.

    Two layouts, told apart by rank:
      * rg (H, W), indices (B,): windows of one radargram;
      * rg (D, pxh, Wmax), indices (B, 2) of (segment, window): windows
        across a zero-padded stack of radargrams sharing one geometry.
    Indices may be a host array (checked here) or a tensor (not checked)."""
    T = geo.length if length is None else length
    stacked = rg.dim() == 3
    if not isinstance(indices, torch.Tensor):
        indices = _checked_host_indices(indices, stacked, geo, T, tuple(rg.shape))
    dev = rg.device
    idx = torch.as_tensor(indices, dtype=torch.int64, device=dev)
    row_idx, col_rel = _window_index_tensors(geo, T, dev)
    if stacked:
        cols = (geo.w - geo.ow) * idx[:, 1, None] + col_rel[None, :]  # (B, T*w)
        x = rg[idx[:, 0, None, None], row_idx[None, :, None], cols[:, None, :]]  # (B, N*h, T*w)
        x = x.reshape(-1, geo.nh, geo.h, T, geo.w)
        return x.permute(0, 3, 1, 2, 4)  # (B, T, N, h, w)
    cols = (geo.w - geo.ow) * idx[:, None] + col_rel[None, :]  # (B, T*w)
    x = rg[row_idx[None, :, None], cols[:, None, :]]  # (B, N*h, T*w)
    x = x.reshape(-1, geo.nh, geo.h, T, geo.w)
    return x.permute(0, 3, 1, 2, 4)  # (B, T, N, h, w)


def make_window_gather(geo: GridGeometry, length: int | None = None):
    """`gather_windows` with the geometry bound: (rg, indices) -> batch."""
    return partial(gather_windows, geo=geo, length=length)


def _same_windowing(a: GridGeometry, b: GridGeometry) -> bool:
    """Same patch and window parameters and height (W may differ)."""
    return (a.h, a.w, a.oh, a.ow, a.length, a.nh) == (b.h, b.w, b.oh, b.ow, b.length, b.nh)


def resident_source(dataset):
    """(rg, geo, index_map) for the resident gather, or None.

    RGWindows: rg (H, W), index_map (len,) window ids. ConcatWindows over
    RGWindows sharing one windowing geometry: rg a (D, pxh, Wmax)
    zero-padded stack, index_map (len, 2) of (segment, local window) pairs.
    SubsetWindows over either maps its positions through its indices."""
    inner = getattr(dataset, "dataset", dataset)  # unwrap SubsetWindows
    if inner is not dataset:
        sub_idx = getattr(dataset, "indices", None)
        if sub_idx is None:
            return None
        sub_idx = np.asarray(sub_idx, dtype=np.int64)
        if sub_idx.size and (sub_idx.min() < 0 or sub_idx.max() >= len(inner)):
            raise ValueError(
                f"dataset index map exceeds the inner dataset's {len(inner)} windows"
            )
    else:
        sub_idx = None

    rg = getattr(inner, "rg", None)
    geo = getattr(inner, "geo", None)
    if isinstance(rg, np.ndarray) and geo is not None:
        index_map = (
            np.arange(len(inner), dtype=np.int32)
            if sub_idx is None
            else sub_idx.astype(np.int32)
        )
        if index_map.size and (index_map.min() < 0 or index_map.max() >= geo.nw):
            raise ValueError(f"dataset index map exceeds the radargram's {geo.nw} windows")
        return rg, geo, index_map

    segments = getattr(inner, "datasets", None)
    if not segments:
        return None
    geo = getattr(inner, "geo", None)
    if geo is None:
        return None
    for d in segments:
        if not isinstance(getattr(d, "rg", None), np.ndarray):
            return None
        if getattr(d, "geo", None) is None or not _same_windowing(d.geo, geo):
            return None
    # memoized on the concat object, so the pipeline's upload memo (keyed on
    # the host array's identity) sees one stack across calls
    memo = getattr(inner, "_resident_stack", None)
    if memo is None:
        w_max = max(d.rg.shape[1] for d in segments)
        stack = np.zeros((len(segments), geo.pxh, w_max), dtype=np.float32)
        for i, d in enumerate(segments):
            stack[i, :, : d.rg.shape[1]] = d.rg[: geo.pxh]
        pairs = np.concatenate([
            np.stack([np.full(len(d), i, dtype=np.int32), np.arange(len(d), dtype=np.int32)],
                     axis=1)
            for i, d in enumerate(segments)
        ])
        memo = (stack, pairs)
        try:
            inner._resident_stack = memo
        except AttributeError:
            pass  # slotted container: rebuilt per call, still correct
    stack, pairs = memo
    index_map = pairs if sub_idx is None else pairs[sub_idx]
    return stack, geo, index_map
