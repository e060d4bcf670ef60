"""Plain seed -> map inference: window extraction, seed columns, top-k label
propagation, the horizontality cross-entropy and its change signal.

Semantics of the upstream label propagation (src/utils.py): frame 0 holds
the one-hot seed; frame t attends over the frames of its context (the last
`cxt` frames, plus each pinned frame f once t - f > cxt), candidate node i
of a context frame counts for query node n when |i - n| < radius on the
(N, 1) patch grid; the affinity <e_i, e_n> / temperature of the best `knn`
candidates is softmaxed and their soft labels summed. Written directly from
that description in PyTorch; nothing here imports the measured program.
"""

from __future__ import annotations

import numpy as np
import torch


def nearest_index(out_size: int, in_size: int) -> np.ndarray:
    """F.interpolate's nearest source index: floor(dst * (in / out)) in
    float32, clipped."""
    scale = np.float32(in_size) / np.float32(out_size)
    idx = np.floor(np.arange(out_size, dtype=np.float32) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize_nearest(x: np.ndarray, out_hw) -> np.ndarray:
    x = np.asarray(x)
    x = np.take(x, nearest_index(out_hw[0], x.shape[-2]), axis=-2)
    return np.take(x, nearest_index(out_hw[1], x.shape[-1]), axis=-1)


def seed_labels(seg_patch: np.ndarray, n_nodes: int) -> np.ndarray:
    """One label per patch node: the patch's segmentation resized to (N, 1)."""
    return resize_nearest(seg_patch, (n_nodes, 1))[:, 0].astype(np.int64)


def windows(rg: torch.Tensor, starts, T: int, N: int, patch, overlap) -> torch.Tensor:
    """Windows of T frames starting at pixel columns `starts` of radargram
    rg (H, W) -> (B, T, N, h, w): frame t of a window is the column strip
    [c0 + t * (w - ow), + w), patch n the rows [n * (h - oh), + h)."""
    h, w = patch
    oh, ow = overlap
    rows = (torch.arange(N)[:, None] * (h - oh) + torch.arange(h)[None, :]).to(rg.device)
    cols = (torch.arange(T)[:, None] * (w - ow) + torch.arange(w)[None, :]).to(rg.device)
    c0 = torch.as_tensor(np.asarray(starts), dtype=torch.int64, device=rg.device)
    cc = c0[:, None, None] + cols[None]  # (B, T, w)
    out = rg[rows[None, None, :, :, None], cc[:, :, None, None, :]]  # (B, T, N, h, w)
    return out.contiguous()


def xent_map(emb: torch.Tensor, tau: float) -> torch.Tensor:
    """(..., T, N, C) normalised embeddings -> (..., N, T-1): for frame pair
    (t, t+1) and node n, logsumexp over source nodes i of <e_t,i, e_t+1,n>
    / tau minus the same-node term."""
    A = torch.einsum("...tic,...tnc->...tin", emb[..., :-1, :, :], emb[..., 1:, :, :]) / tau
    out = torch.logsumexp(A, dim=-2) - torch.diagonal(A, dim1=-2, dim2=-1)
    return out.transpose(-1, -2)


def change_signal(xent: torch.Tensor) -> torch.Tensor:
    """(..., N, T-1) -> (..., T-2): sum over nodes of |x_i - x_i+1|."""
    return (xent[..., :-1] - xent[..., 1:]).abs().sum(dim=-2)


@torch.no_grad()
def propagate(emb: torch.Tensor, seeds: torch.Tensor, nclasses: int, cxt: int, radius: float,
              temperature: float, knn: int, long_mem=(0,)) -> torch.Tensor:
    """emb (B, T, N, C) normalised, seeds (B, N) int labels -> soft labels
    (B, T, N, M), frame 0 the one-hot seed."""
    B, T, N, _ = emb.shape
    soft = torch.zeros((B, T, N, nclasses), dtype=torch.float32, device=emb.device)
    soft[:, 0] = torch.nn.functional.one_hot(seeds.long(), nclasses).float()
    node = torch.arange(N, device=emb.device)
    near = (node[:, None] - node[None, :]).abs().float() < radius  # (N_src, N_query)
    for t in range(1, T):
        ctx = [f for f in long_mem if f < t and t - f > cxt] + list(range(max(0, t - cxt), t))
        feats = emb[:, ctx]  # (B, S, N, C)
        aff = torch.einsum("bsic,bnc->bnsi", feats, emb[:, t]) / temperature
        aff = aff.masked_fill(~near.T[None, :, None, :], -torch.inf)
        flat = aff.reshape(B, N, -1)
        vals, idx = torch.topk(flat, min(knn, flat.shape[-1]), dim=-1)
        w = torch.softmax(vals, dim=-1)  # (B, N, k)
        labels = soft[:, ctx].reshape(B, -1, nclasses)  # (B, S * N, M)
        picked = torch.gather(labels[:, None].expand(B, N, *labels.shape[1:]), 2,
                              idx[..., None].expand(*idx.shape, nclasses))
        soft[:, t] = (w[..., None] * picked).sum(dim=2)
    return soft


def disagreements(soft: torch.Tensor, classes: torch.Tensor) -> tuple[int, int]:
    """(entries whose class is not the soft labels' best, entries): soft
    (..., M), classes (...) int."""
    return int((soft.argmax(dim=-1) != classes.long()).sum()), int(classes.numel())
