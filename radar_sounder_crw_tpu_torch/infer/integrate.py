"""Bidirectional integration: merge forward and reverse propagation passes.

The reverse pass propagates from the LAST frame (`use_last`); its
prediction is flipped back and merged into the forward map with
dataset-specific class priority masks:

  * MCORDS1-style: reverse bedrock (2) overrides; then reverse noise (1)
    overrides where forward isn't bedrock.
  * MCORDS3-style: reverse bedrock (2) / inland ice (3) override only in
    columns with no floating ice (4) anywhere in the forward map.
  * the flat merges of the upstream test_all script, on flattened maps.

A copy of radar_sounder_crw_tpu/infer/integrate.py. The line-sized steps
(the flip back, the flat merge) split the map's rows into bands worked by
threads: numpy releases the GIL inside them.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.profiling import span

_BAND_BYTES = 1 << 20  # the least of a map a band is worth a thread for


def _over_row_bands(fn, shape: tuple, itemsize: int) -> list:
    """[fn(rows) for rows in bands of the map's rows]: as many bands as
    torch's intra-op threads, each at least _BAND_BYTES, one thread each;
    one band on the calling thread where the map is smaller."""
    rows = shape[0]
    n = max(1, min(torch.get_num_threads(), rows, int(np.prod(shape)) * itemsize // _BAND_BYTES))
    edges = np.linspace(0, rows, n + 1).astype(int)
    bands = [slice(a, b) for a, b in zip(edges[:-1], edges[1:])]
    if n == 1:
        return [fn(bands[0])]
    with ThreadPoolExecutor(n) as pool:
        return list(pool.map(fn, bands))


def reverse_unfold_flip(pred: np.ndarray, rg_len: int) -> np.ndarray:
    """Flip each rg_len-wide block of a concatenated prediction map back to
    forward orientation (span `crw.assemble.unflip`): one strided copy, in
    the map's dtype, by bands of rows."""
    with span("crw.assemble.unflip"):
        H, W = pred.shape
        nblocks = W // rg_len
        blocks = pred[:, : nblocks * rg_len].reshape(H, nblocks, rg_len)
        out = np.empty(blocks.shape, pred.dtype)

        def flip(rows):
            out[rows] = blocks[rows, :, ::-1]

        _over_row_bands(flip, out.shape, out.itemsize)
        return out.reshape(H, nblocks * rg_len)


def integrate_bidirectional(
    forward: np.ndarray,
    reverse: np.ndarray,
    style: str,
    bedrock: int = 2,
    noise: int = 1,
    inland_ice: int = 3,
    floating_ice: int = 4,
) -> np.ndarray:
    """Merge a reverse-pass map into the forward map. `reverse` must already
    be flipped back to forward orientation (span `crw.assemble.merge`)."""
    with span("crw.assemble.merge"):
        out = np.asarray(forward).copy()
        rev = np.asarray(reverse)
        if style == "mcords1":
            out[rev == bedrock] = bedrock
            mask2 = (rev == noise) & (forward != bedrock)
            out[mask2] = noise
        elif style == "mcords3":
            no_shelf = ~np.any(forward == floating_ice, axis=0, keepdims=True)
            no_shelf = np.broadcast_to(no_shelf, forward.shape)
            out[(rev == bedrock) & no_shelf] = bedrock
            out[(rev == inland_ice) & no_shelf] = inland_ice
        elif style == "bedrock_only":
            out[rev == bedrock] = bedrock
        else:
            raise ValueError(f"unknown integration style {style!r}")
        return out


def integrate_flat_mcords3(
    forward_flat: np.ndarray, reverse_map: np.ndarray, bedrock: int = 2,
    inland_ice_fwd_guard: int = 3, floating_ice: int = 4,
) -> np.ndarray:
    """The Miguel merge on flattened maps: reverse bedrock wins where forward
    isn't inland ice AND the reverse column holds no floating ice (span
    `crw.assemble.merge`).

    One copy of forward_flat, in its dtype, merged through its 2-D view
    by bands of rows: a band's mask (reverse bedrock, and-ed with the
    (1, W) row of clear columns and the forward guard) and one masked
    write. The inputs are left as they are."""
    with span("crw.assemble.merge"):
        rev = np.asarray(reverse_map)
        src = np.asarray(forward_flat).reshape(rev.shape)
        out = np.empty(rev.shape, src.dtype)
        floating = _over_row_bands(lambda rows: (rev[rows] == floating_ice).any(axis=0),
                                   rev.shape, out.itemsize)
        clear = ~np.logical_or.reduce(floating)

        def merge(rows):
            grid = out[rows]
            grid[...] = src[rows]
            mask = rev[rows] == bedrock
            mask &= clear
            mask &= grid != inland_ice_fwd_guard
            np.copyto(grid, bedrock, where=mask)

        _over_row_bands(merge, rev.shape, out.itemsize)
        return out.reshape(-1)
