"""Plain assembly of a flight line's map from its passes, as the upstream
batch evaluation does it (scripts/test_all.py with --correction --use_last
on the MCoRDS3 "Miguel" line): each radargram's patch map resized (nearest)
to its pixels; after a change point at frame c < T - 1, the last
(T - c) * (w - ow) pixel columns replaced by the map of the corrected pass;
the reverse pass's maps flipped back radargram by radargram; reverse
bedrock (2) written over forward pixels that are not inland ice (3), in
columns where the reverse map has no floating ice (4).

Also the Miguel trim: each of the seven concatenated sub-radargrams cut to a
multiple of w * T columns. Nothing here imports the measured program.
"""

from __future__ import annotations

import numpy as np

from .propagate import resize_nearest


def trim(x: np.ndarray, splits, T: int, w: int) -> np.ndarray:
    starts = np.concatenate([[0], np.cumsum(splits)[:-1]])
    return np.concatenate([x[:, s:s + (n // (w * T)) * (w * T)] for s, n in zip(starts, splits)],
                          axis=1)


def flip_blocks(x: np.ndarray, rg_len: int) -> np.ndarray:
    """Each rg_len-wide block of columns reversed in place."""
    H, W = x.shape
    n = W // rg_len
    return x[:, :n * rg_len].reshape(H, n, rg_len)[:, :, ::-1].reshape(H, n * rg_len)


def corrections(change: list, T: int, w: int, ow: int) -> list:
    """[(radargram, pixel offset, corrected length)] of the change points
    that get a correction."""
    out = []
    for t, c in enumerate(change):
        if c is None or c >= T - 1:
            continue
        out.append((t, (T - c) * (w - ow), T - c))
    return out


def assemble(fwd: np.ndarray, change: list, corrected: dict, rev: np.ndarray | None,
             H: int, T: int, w: int, ow: int, merge: str) -> np.ndarray:
    """The line's flat pixel map from fwd (R, N, T) patch maps, the change
    points, corrected {(T', t): (N, T') map} and rev (R, N, T) maps (None:
    no reverse pass). Raises KeyError when a due correction is missing."""
    rg_len = T * (w - ow) + ow
    cols = []
    for t in range(fwd.shape[0]):
        px = resize_nearest(fwd[t].astype(np.int32), (H, rg_len))
        cols.append(px)
    for t, off, small in corrections(change, T, w, ow):
        up = resize_nearest(np.asarray(corrected[(small, t)]).astype(np.int32), (H, off))
        cols[t] = cols[t].copy()
        cols[t][:, -off:] = up
    final = np.concatenate(cols, axis=1).ravel()
    if rev is None:
        return final
    rev_map = flip_blocks(np.concatenate(
        [resize_nearest(r.astype(np.int32), (H, rg_len)) for r in rev], axis=1), rg_len)
    if merge != "mcords3_flat":
        raise ValueError(f"unknown merge {merge!r}")
    clear = np.all(rev_map != 4, axis=0)
    mask = (rev_map.ravel() == 2) & (final != 3) & np.broadcast_to(clear, rev_map.shape).ravel()
    final = final.copy()
    final[mask] = 2
    return final
