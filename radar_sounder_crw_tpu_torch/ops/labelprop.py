"""User-guided label propagation: top-k masked attention over CRW embeddings.

Frame 0 carries the seed labels (one-hot over classes, one per patch node).
Each later frame t attends, node by node, over a context of already-labelled
source nodes held in a ring buffer:

  * slots [0, L) pin the `long_mem` frames (default (0,): frame 0); a pinned
    slot becomes valid only once its frame has left the recent window
    (t - frame > cxt), so every context frame counts once;
  * slots [L, L + cxt) are a circular window of the last cxt frames (frame t
    is pushed to slot L + t mod cxt);
  * affinity = (feats . query + radius mask + slot validity bias) /
    temperature, then the exact top-knn per query (lowest candidate index on
    ties), a softmax over the winners and the weighted sum of their labels.

The semantics are those of radar_sounder_crw_tpu/ops/labelprop.py. The frame
loop runs in Python, one step launch per frame; the ring lives on the device
and is updated in place. The step runs either as the plain PyTorch `_prop_step`
below (kernel="torch", the CPU path and the twin the CUDA kernel is held
against) or as the hand-written CUDA kernel (kernel="cuda",
ops/labelprop_cuda.py).

Both walk only the valid slot PREFIX L + min(t, cxt): the slots beyond it
have not been written yet and carry the NEG_INVALID bias, so their softmax
weight is exactly 0 and skipping them changes no output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device

NEG_MASKED = -1e10  # radius-mask fill
NEG_INVALID = -1e12  # empty or not-yet-active ring slots: below every candidate


@dataclasses.dataclass(frozen=True)
class LabelPropConfig:
    """Propagation settings; see the module docstring for `long_mem`."""

    cxt_size: int = 100
    radius: float = 10
    temperature: float = 0.1
    knn: int = 20
    long_mem: tuple[int, ...] = (0,)


def radius_mask(h: int, w: int, radius: float) -> np.ndarray:
    """(h*w, h*w) additive mask: 0 within Euclidean `radius` on the (h, w)
    patch grid, NEG_MASKED outside."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float32)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    return np.where(np.sqrt(d2) < radius, 0.0, NEG_MASKED).astype(np.float32)


def _push_frame(long_mem, feats, labels, t: int, q, pred) -> None:
    """Write frame t's features and labels into the ring IN PLACE: ring slot
    L + t mod cxt, plus slot j when t is the pinned frame long_mem[j]."""
    L = len(long_mem)
    cxt = feats.shape[0] - L
    slot = L + t % cxt
    feats[slot].copy_(q)
    labels[slot].copy_(pred)
    for j, fj in enumerate(long_mem):
        if t == fj:
            feats[j].copy_(q)
            labels[j].copy_(pred)


def _slot_validity(long_mem, cxt: int, t: torch.Tensor) -> torch.Tensor:
    """(len(t), L + cxt) 1/0 slot validity for the steps predicting frames t.

    Ring slots hold exactly the last min(t, cxt) frames; a pinned slot is
    valid once its frame has left the recent window (t - frame > cxt)."""
    t = t[:, None]
    ring = (torch.arange(cxt, device=t.device)[None, :] < torch.clamp(t, max=cxt))
    if not long_mem:
        return ring.float()
    pins = torch.as_tensor(long_mem, device=t.device)[None, :]
    return torch.cat([(t - pins > cxt), ring], dim=1).float()


def _prop_step(feats, query, mask, slot_bias, labels, temperature: float, knn: int, nslots: int):
    """One propagation frame in plain PyTorch: the CUDA kernel's twin.

    feats (K, N, C); query (N, C); mask (N_src, N_query) additive;
    slot_bias (K,) additive per slot; labels (K, N, M). Only the first
    `nslots` slots are read. Returns pred (N, M).

    The winners come from a stable descending sort of the flattened
    (nslots*N) candidate axis, which puts the lowest candidate index first
    among equal values, as `lax.top_k` does; `torch.topk` promises no tie
    order. The temperature divides through a device tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which moves
    values by an ulp and can flip top-k ties."""
    K, N, C = feats.shape
    M = labels.shape[-1]
    f = feats[:nslots]
    temp = torch.full((), temperature, dtype=torch.float32, device=feats.device)
    aff = torch.einsum("knc,mc->knm", f, query)
    aff = (aff + mask[None] + slot_bias[:nslots, None, None]) / temp
    flat = aff.reshape(nslots * N, N).T  # (N_query, candidates)
    k = min(knn, nslots * N)
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    w = torch.softmax(vals[:, :k], dim=-1)
    src = labels[:nslots].reshape(nslots * N, M)[idx[:, :k]]  # (N, k, M)
    return torch.einsum("nk,nkm->nm", w, src)


def _validate_cfg(cfg: LabelPropConfig, N: int, grid_hw, device):
    """Returns (radius mask (N, N) on `device`, long_mem tuple)."""
    h, w = grid_hw if grid_hw is not None else (N, 1)
    if h * w != N:
        raise ValueError(f"grid {h}x{w} != {N} nodes")
    if cfg.cxt_size < 1:
        raise ValueError("cxt_size must be >= 1 (need at least one recent-frame slot)")
    if cfg.knn < 1:
        raise ValueError(f"knn must be >= 1, got {cfg.knn}")
    long_mem = tuple(int(j) for j in cfg.long_mem)
    if list(long_mem) != sorted(set(long_mem)) or (long_mem and long_mem[0] < 0):
        raise ValueError(
            f"long_mem must be strictly increasing non-negative frame "
            f"indices, got {cfg.long_mem}"
        )
    mask = torch.as_tensor(radius_mask(h, w, cfg.radius), device=device)
    return mask, long_mem


def resolve_kernel(kernel: str, device: torch.device) -> str:
    """'auto' -> 'cuda' on a CUDA device, 'torch' on the CPU. The CUDA kernel
    on a CPU device is an error, not a silent switch."""
    if kernel == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if kernel not in ("torch", "cuda"):
        raise ValueError(f"unknown kernel {kernel!r} (expected 'auto', 'torch' or 'cuda')")
    if kernel == "cuda" and device.type != "cuda":
        raise ValueError(f"kernel='cuda' needs a CUDA device, got {device}")
    return kernel


@torch.no_grad()
def propagate_labels(
    emb, seed_labels, cfg: LabelPropConfig, grid_hw=None, kernel: str = "auto",
    device=None,
):
    """Propagate seed labels through a frame sequence.

    Args:
      emb: (T, N, C) L2-normalized per-node embeddings.
      seed_labels: (N, M) one-hot (or soft) labels of frame 0.
      cfg: LabelPropConfig.
      grid_hw: patch-grid shape per frame; default (N, 1), a vertical column
        of patches.
      kernel: 'torch' (plain step), 'cuda' (the hand-written kernel) or
        'auto' ('cuda' on a CUDA device, 'torch' on the CPU).
      device: where to run; default cuda (raises when CUDA is absent).

    Returns:
      soft: (T, N, M) float32 soft labels per frame (frame 0 = the seed).
      pred: (T, N) int64 argmax labels (first maximum on ties).
    """
    device = resolve_device(device)
    kernel = resolve_kernel(kernel, device)
    if kernel == "cuda":
        from .labelprop_cuda import prop_step as step
    else:
        step = _prop_step
    emb = torch.as_tensor(emb, dtype=torch.float32, device=device).contiguous()
    seed = torch.as_tensor(seed_labels, dtype=torch.float32, device=device)
    T, N, C = emb.shape
    M = seed.shape[-1]
    mask, long_mem = _validate_cfg(cfg, N, grid_hw, device)
    L, cxt = len(long_mem), cfg.cxt_size
    K = L + cxt
    knn = min(cfg.knn, K * N)

    feats = torch.zeros((K, N, C), dtype=torch.float32, device=device)
    labels = torch.zeros((K, N, M), dtype=torch.float32, device=device)
    _push_frame(long_mem, feats, labels, 0, emb[0], seed)
    soft = torch.empty((T, N, M), dtype=torch.float32, device=device)
    soft[0] = seed
    # every frame's slot bias at once, one small upload instead of T
    frames = torch.arange(1, T, device=device)
    bias_all = (1.0 - _slot_validity(long_mem, cxt, frames)) * NEG_INVALID
    for t in range(1, T):
        nslots = L + min(t, cxt)
        pred = step(
            feats, emb[t], mask, bias_all[t - 1], labels, cfg.temperature, knn, nslots
        )
        soft[t] = pred
        _push_frame(long_mem, feats, labels, t, emb[t], pred)
    return soft, soft.argmax(dim=-1)
