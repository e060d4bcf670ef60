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

The semantics are those of radar_sounder_crw_tpu/ops/labelprop.py. Four
routes compute them for a batch of radargrams (`propagate_labels_batched`;
`propagate_labels` is its B = 1 view):

  * kernel="torch": a Python frame loop over a (B, K, N, C) feature ring and
    a (B, K, N, M) label ring on the device, one plain batched step
    (`_prop_step_batched`) per frame. It is the CPU path and the twin the
    `prop_step` and `prop_seq` kernels are held against
    (`propagate_seq_reference`).
  * kernel="cuda": the same loop, radargram by radargram, with the
    hand-written per-frame kernel `prop_step` (ops/labelprop_cuda.py).
  * kernel="cuda_seq": the hand-written whole-sequence kernel `prop_seq`,
    one launch for all B x (T-1) frames. 'auto' takes it on a CUDA device
    for one radargram and for a batch alike (`_route`).
  * kernel="cuda_resident": the hand-written whole-sequence kernel
    `prop_all`, one launch for the batch, with the weight arithmetic of the
    TPU's resident kernel (`_prop_all_step_batched`; its twin is
    `propagate_all_reference`). It equals the other routes up to an ulp of
    the summation order; 'auto' never picks it.

The kernels split the work in ways the plain loop does not, and each split
has its plain twin here, equal to the loop bit for bit on exact inputs:
`_winners_chunked` (prop_step's block top-k lists over candidate chunks and
their merge), `_winners_all_frames` + `_label_chain` (prop_seq's every
frame's winners from the embeddings alone, then the label chain) and
`_weights_all_frames` + `_label_chain(..., weights_only=True)` (prop_all's
every frame's normalised weights in candidate-row order, then a chain of
weighted sums alone).

All walk only the valid slot PREFIX L + min(t, cxt): the slots beyond it
have not been written yet and carry the NEG_INVALID bias, so their softmax
weight is exactly 0 and skipping them changes no output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import span

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
    """Write frame t's features and labels into the batched ring IN PLACE:
    ring slot L + t mod cxt, plus slot j when t is the pinned frame
    long_mem[j]. feats (B, K, N, C), labels (B, K, N, M)."""
    L = len(long_mem)
    cxt = feats.shape[1] - L
    slot = L + t % cxt
    feats[:, slot].copy_(q)
    labels[:, slot].copy_(pred)
    for j, fj in enumerate(long_mem):
        if t == fj:
            feats[:, j].copy_(q)
            labels[:, j].copy_(pred)


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


def _winners(feats, query, mask, slot_bias, temperature: float, knn: int, nslots: int):
    """The top-k candidates of one frame for B radargrams: their candidate
    indices idx (B, N, k) in winner order and e_j = exp(v_j - v_0) (B, N, k),
    k = min(knn, nslots*N).

    feats (B, K, N, C); query (B, N, C); mask (N_src, N_query) additive;
    slot_bias (K,) additive per slot. Only the first `nslots` slots are read.

    The winners come from a stable descending sort of the flattened
    (nslots*N) candidate axis, which puts the lowest candidate index first
    among equal values, as `lax.top_k` does; `torch.topk` promises no tie
    order. The temperature divides through a device tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which moves
    values by an ulp and can flip top-k ties."""
    flat = _affinity(feats, query, mask, slot_bias, temperature, nslots)
    k = min(knn, flat.shape[-1])
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return idx, torch.exp(vals - vals[..., :1])


def _affinity(feats, query, mask, slot_bias, temperature: float, nslots: int):
    """The masked, biased, tempered affinity of `_winners`: (B, N_query,
    nslots*N) over the candidates r = s*N + i."""
    B, K, N, C = feats.shape
    temp = torch.full((), temperature, dtype=torch.float32, device=feats.device)
    aff = torch.einsum("bknc,bmc->bknm", feats[:, :nslots], query)
    aff = (aff + mask + slot_bias[:nslots, None, None]) / temp
    return aff.reshape(B, nslots * N, query.shape[1]).transpose(1, 2)


def _chunk_lists(flat, knn: int, chunk: int):
    """The block top-k of the `prop_step` kernel's first step: for each run
    of `chunk` candidates of flat (B, N_query, candidates), its knn best
    (value, index) in winner order -> (B, N_query, n_chunks, knn) each,
    padded with (-inf, INT32_MAX) where a chunk holds fewer than knn."""
    B, Nq, ncand = flat.shape
    n_chunks = -(-ncand // chunk)
    vals = torch.full((B, Nq, n_chunks, knn), -torch.inf, dtype=flat.dtype, device=flat.device)
    idx = torch.full((B, Nq, n_chunks, knn), torch.iinfo(torch.int32).max, dtype=torch.int64,
                     device=flat.device)
    for c in range(n_chunks):
        v, i = torch.sort(flat[..., c * chunk : (c + 1) * chunk], dim=-1, descending=True,
                          stable=True)
        k = min(knn, v.shape[-1])
        vals[:, :, c, :k] = v[..., :k]
        idx[:, :, c, :k] = i[..., :k] + c * chunk
    return vals, idx


def _winners_chunked(feats, query, mask, slot_bias, temperature: float, knn: int, nslots: int,
                     chunk: int):
    """`_winners` as the `prop_step` kernel finds them: each chunk's top-knn
    (`_chunk_lists`), then a lexicographic merge of the chunk lists. A
    stable descending sort of the lists in chunk order is that merge: the
    chunks are in candidate order and each list is in winner order. Equals
    `_winners` exactly, indices and weights."""
    flat = _affinity(feats, query, mask, slot_bias, temperature, nslots)
    vals, idx = _chunk_lists(flat, knn, chunk)
    vals, idx = vals.flatten(-2), idx.flatten(-2)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    k = min(knn, flat.shape[-1])
    vals, idx = vals[..., :k], torch.gather(idx, -1, order)[..., :k]
    return idx, torch.exp(vals - vals[..., :1])


def _gather_labels(labels, idx, nslots: int):
    """labels (B, K, N, M) at the candidates idx (B, N, k) -> (B, N, k, M)."""
    B, _, N, M = labels.shape
    rows = torch.arange(B, device=labels.device)[:, None, None]
    return labels[:, :nslots].reshape(B, nslots * N, M)[rows, idx]


def _prop_step_batched(feats, query, mask, slot_bias, labels, temperature: float, knn: int,
                       nslots: int):
    """One propagation frame for B radargrams in plain PyTorch: the twin of
    the `prop_step` and `prop_seq` kernels.

    feats (B, K, N, C); query (B, Nq, C), all N query nodes or a block of
    them (`_query_blocks`); mask (N, Nq) additive; slot_bias (K,) additive
    per slot; labels (B, K, N, M). Only the first `nslots` slots are read.
    Returns pred (B, Nq, M).

    The winners come from `_winners`. The softmax-weighted sum runs winner
    by winner, e_j = exp(v_j - v_0), num += e_j * label_j, den += e_j,
    pred = num / den: the order and the roundings of the kernels
    (csrc/prop_common.cuh)."""
    B, Nq = query.shape[:2]
    idx, e = _winners(feats, query, mask, slot_bias, temperature, knn, nslots)
    src = _gather_labels(labels, idx, nslots)  # (B, Nq, k, M)
    num = torch.zeros((B, Nq, labels.shape[-1]), dtype=torch.float32, device=feats.device)
    den = torch.zeros((B, Nq, 1), dtype=torch.float32, device=feats.device)
    for j in range(idx.shape[-1]):
        num = num + e[..., j, None] * src[..., j, :]
        den = den + e[..., j, None]
    return num / den


def _prop_all_step_batched(feats, query, mask, slot_bias, labels, temperature: float, knn: int,
                           nslots: int):
    """One propagation frame with the weight arithmetic of the TPU's
    resident kernel (`_prop_all_kernel`): the twin of the `prop_all` kernel.
    Arguments and winners as in `_prop_step_batched`.

    Contract, shared bit for bit with csrc/prop_all.cu:
      * den = sum_j e_j, accumulated in winner order j = 0, 1, ...;
      * w_j = e_j / den, an IEEE division (`_row_order_weights`);
      * pred = sum_j w_j * label_j over the winners in ASCENDING candidate
        index (the row order in which the TPU kernel's product labels . W
        reads them), the product and the sum rounded separately.
    It differs from `_prop_step_batched`'s (sum e_j * label_j) / den by an
    ulp or so. Walking only the prefix changes nothing against the TPU
    kernel's full-ring sweep: the slots past it carry NEG_INVALID, so a
    winner there (knn above the prefix's candidates) has e_j = 0 exactly
    and adds +0 to den and to pred."""
    B, _, N, _ = feats.shape
    idx, w = _row_order_weights(
        *_winners(feats, query, mask, slot_bias, temperature, knn, nslots))
    src = _gather_labels(labels, idx, nslots)  # (B, N, k, M)
    pred = torch.zeros((B, N, labels.shape[-1]), dtype=torch.float32, device=feats.device)
    for j in range(idx.shape[-1]):
        pred = pred + w[..., j, None] * src[..., j, :]
    return pred


def _row_order_weights(idx, e):
    """The resident kernel's weights of `_winners`' lists (idx, e), (..., k)
    each: den = sum_j e_j accumulated in winner order, w_j = e_j / den, then
    the entries in ascending candidate index -> (idx, w)."""
    den = torch.zeros_like(e[..., :1])
    for j in range(e.shape[-1]):
        den = den + e[..., j, None]
    idx, order = torch.sort(idx, dim=-1)  # candidate indices are distinct
    return idx, torch.gather(e / den, -1, order)


def _prop_step(feats, query, mask, slot_bias, labels, temperature: float, knn: int, nslots: int):
    """One frame of one radargram (feats (K, N, C), query (N, C), labels
    (K, N, M) -> pred (N, M)): the B = 1 view of `_prop_step_batched`, the
    twin of the `prop_step` kernel."""
    return _prop_step_batched(
        feats[None], query[None], mask, slot_bias, labels[None], temperature, knn, nslots
    )[0]


def _frame_loop(emb, seeds, mask, long_mem, cxt: int, temperature: float, knn: int, step):
    """The frame loop over a batched ring: emb (B, T, N, C), seeds (B, N, M)
    -> soft (B, T, N, M), frame 0 the seeds. `step` predicts one frame
    (`_prop_step_batched` or a kernel with its signature)."""
    B, T, N, C = emb.shape
    M = seeds.shape[-1]
    dev = emb.device
    L = len(long_mem)
    K = L + cxt
    feats = torch.zeros((B, K, N, C), dtype=torch.float32, device=dev)
    labels = torch.zeros((B, K, N, M), dtype=torch.float32, device=dev)
    _push_frame(long_mem, feats, labels, 0, emb[:, 0], seeds)
    soft = torch.empty((B, T, N, M), dtype=torch.float32, device=dev)
    soft[:, 0] = seeds
    # every frame's slot bias at once, one small upload instead of T
    frames = torch.arange(1, T, device=dev)
    bias_all = (1.0 - _slot_validity(long_mem, cxt, frames)) * NEG_INVALID
    for t in range(1, T):
        nslots = L + min(t, cxt)
        pred = step(feats, emb[:, t], mask, bias_all[t - 1], labels, temperature, knn, nslots)
        soft[:, t] = pred
        _push_frame(long_mem, feats, labels, t, emb[:, t], pred)
    return soft


def propagate_seq_reference(emb, seeds, mask, long_mem, cxt: int, temperature: float, knn: int):
    """The plain PyTorch twin of the `prop_seq` kernel: the whole propagation
    of B radargrams, emb (B, T, N, C), seeds (B, N, M) -> soft (B, T, N, M),
    one batched step per frame over a (B, K, N, C) feature ring and a
    (B, K, N, M) label ring."""
    return _frame_loop(emb, seeds, mask, tuple(long_mem), cxt, temperature, knn,
                       _prop_step_batched)


def _slot_frames(long_mem, cxt: int, t: int, nslots: int) -> list[int]:
    """The frame each of the first `nslots` ring slots holds while frame t
    is predicted (-1: a pin not written yet)."""
    pins = [fj if fj < t else -1 for fj in long_mem]
    return (pins + [r + cxt * ((t - 1 - r) // cxt) for r in range(min(t, cxt))])[:nslots]


def _lists_all_frames(emb, mask, long_mem, cxt: int, temperature: float, knn: int, reorder=None):
    """Every frame's winner lists from the embeddings alone (they read no
    label): emb (B, T, N, C) -> (f, i, x), each (B, T - 1, N, knn). Entry j
    of query n at frame t is node i of frame f (f = -1: a pin not written
    yet, whose labels read 0) with value x; a frame with fewer than knn
    candidates pads with (-1, 0, 0) at the end. The affinities and the top-k
    are `_winners` on the same feature ring as `propagate_seq_reference`.
    `reorder` maps `_winners`' (idx, e) to the (idx, x) stored; default: as
    they are, winner order with x = e."""
    B, T, N, C = emb.shape
    long_mem = tuple(long_mem)
    L = len(long_mem)
    dev = emb.device
    f = torch.full((B, T - 1, N, knn), -1, dtype=torch.int64, device=dev)
    i = torch.zeros((B, T - 1, N, knn), dtype=torch.int64, device=dev)
    x = torch.zeros((B, T - 1, N, knn), dtype=torch.float32, device=dev)
    feats = torch.zeros((B, L + cxt, N, C), dtype=torch.float32, device=dev)
    no_labels = torch.zeros((B, L + cxt, N, 0), dtype=torch.float32, device=dev)
    _push_frame(long_mem, feats, no_labels, 0, emb[:, 0], no_labels[:, 0])
    bias_all = (1.0 - _slot_validity(long_mem, cxt, torch.arange(1, T, device=dev))) * NEG_INVALID
    for t in range(1, T):
        nslots = L + min(t, cxt)
        idx, xs = _winners(feats, emb[:, t], mask, bias_all[t - 1], temperature, knn, nslots)
        if reorder is not None:
            idx, xs = reorder(idx, xs)
        k = idx.shape[-1]
        frames = torch.as_tensor(_slot_frames(long_mem, cxt, t, nslots), device=dev)
        f[:, t - 1, :, :k] = frames[idx // N]
        i[:, t - 1, :, :k] = idx % N
        x[:, t - 1, :, :k] = xs
        _push_frame(long_mem, feats, no_labels, t, emb[:, t], no_labels[:, 0])
    return f, i, x


def _winners_all_frames(emb, mask, long_mem, cxt: int, temperature: float, knn: int):
    """Phase A of the `prop_seq` kernel in plain PyTorch: `_lists_all_frames`
    in winner order with e_j = exp(v_j - v_0), so the lists are
    `propagate_seq_reference`'s winners bit for bit."""
    return _lists_all_frames(emb, mask, long_mem, cxt, temperature, knn)


def _weights_all_frames(emb, mask, long_mem, cxt: int, temperature: float, knn: int):
    """Steps 1 and 2 of the `prop_all` kernel in plain PyTorch:
    `_lists_all_frames` with `_row_order_weights`, each frame's entries in
    ascending candidate row s*N + i (slot order, not frame order: the two
    part once the ring wraps or a pin is read) with w_j = e_j / den. An
    entry of a slot that is not valid (a pin whose frame is still in the
    ring, or not yet written) has e_j = 0 exactly, so w_j = 0."""
    return _lists_all_frames(emb, mask, long_mem, cxt, temperature, knn, _row_order_weights)


def _label_chain(lists, seeds, weights_only: bool = False):
    """The label chain of the whole-sequence kernels in plain PyTorch: the
    labels frame by frame from `_lists_all_frames`' lists (f, i, x) and
    seeds (B, N, M) -> soft (B, T, N, M), frame 0 the seeds. Entry by entry
    in the stored order, x_j * soft[f_j, i_j] summed unfused as in
    `_prop_step_batched`; the padding (x = 0, no label) adds +0.
      * `prop_seq`'s phase B: soft[t] = sum / sum_j x_j; with the lists of
        `_winners_all_frames` it equals `propagate_seq_reference` bit for
        bit.
      * weights_only (`prop_all`'s step 3): soft[t] = sum; with the lists of
        `_weights_all_frames` it equals `propagate_all_reference` bit for
        bit."""
    f, i, x = lists
    B, T1, N, k = f.shape
    soft = torch.empty((B, T1 + 1, N, seeds.shape[-1]), dtype=torch.float32, device=seeds.device)
    soft[:, 0] = seeds
    rows = torch.arange(B, device=seeds.device)[:, None, None]
    for t in range(1, T1 + 1):
        ft = f[:, t - 1]
        src = soft[rows, ft.clamp(min=0), i[:, t - 1]]  # (B, N, k, M)
        src = torch.where((ft >= 0)[..., None], src, 0.0)
        num = torch.zeros_like(soft[:, 0])
        den = torch.zeros((B, N, 1), dtype=torch.float32, device=seeds.device)
        for j in range(k):
            num = num + x[:, t - 1, :, j, None] * src[:, :, j]
            den = den + x[:, t - 1, :, j, None]
        soft[:, t] = num if weights_only else num / den
    return soft


def propagate_all_reference(emb, seeds, mask, long_mem, cxt: int, temperature: float, knn: int):
    """The plain PyTorch twin of the `prop_all` kernel: emb (B, T, N, C),
    seeds (B, N, M) -> soft (B, T, N, M), frame 0 the seeds; the frame loop
    of `propagate_seq_reference` with the resident kernel's weight
    arithmetic (`_prop_all_step_batched`)."""
    return _frame_loop(emb, seeds, mask, tuple(long_mem), cxt, temperature, knn,
                       _prop_all_step_batched)


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


KERNELS = ("torch", "cuda", "cuda_seq", "cuda_resident")


def resolve_kernel(kernel: str, device: torch.device) -> str:
    """'auto' -> 'cuda_seq' on a CUDA device, for one radargram and for a
    batch alike, 'torch' on the CPU; never 'cuda_resident', which is chosen
    by name only. Names outside KERNELS raise, and so does a CUDA kernel on
    a CPU device: nothing switches quietly. The call's own limits can still
    send 'auto' elsewhere (`_route`)."""
    if kernel == "auto":
        return "cuda_seq" if device.type == "cuda" else "torch"
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (expected 'auto' or one of {KERNELS})")
    if kernel.startswith("cuda") and device.type != "cuda":
        raise ValueError(f"kernel={kernel!r} needs a CUDA device, got {device}")
    return kernel


AUTO_ORDER = ("cuda_seq", "cuda")  # the kernels 'auto' tries on a CUDA device, in order


def _route(kernel: str, device: torch.device, query_block, T: int, N: int, M: int, knn: int,
           long_mem: tuple, cxt: int) -> str:
    """The route of one call, decided before any launch. 'auto' takes the
    first kernel of AUTO_ORDER whose limits (knn, classes, shared memory;
    `labelprop_cuda.fits`) take this call's shapes: the whole-sequence
    kernel, else the per-frame one, else the plain route on the same
    device, as the JAX package's 'auto' takes XLA where `plan_blocks` finds
    no plan. A `query_block` sends 'auto' to the plain route. A kernel
    chosen by name is never switched: with a `query_block` it raises here,
    past its limits its wrapper raises.

    One radargram takes the whole-sequence kernel on purpose, where the JAX
    package's 'auto' takes its per-frame kernel: on the H100 a launch a
    frame costs more host time than the frame's device work."""
    auto = kernel == "auto"
    kernel = resolve_kernel(kernel, device)
    if kernel == "torch":
        return kernel
    if query_block is not None:
        if not auto:
            raise ValueError(
                f"query_block applies to the plain route only (kernel='torch' or 'auto'), "
                f"not kernel={kernel!r}"
            )
        return "torch"
    if not auto:
        return kernel
    from .labelprop_cuda import fits

    return next((route for route in AUTO_ORDER
                 if fits(route, device, T, N, M, knn, len(long_mem), cxt)), "torch")


def _cuda_step(feats, query, mask, slot_bias, labels, temperature, knn, nslots):
    """The `prop_step` kernel in `_frame_loop`'s batched signature (B = 1)."""
    from .labelprop_cuda import prop_step

    return prop_step(feats[0], query[0], mask, slot_bias, labels[0], temperature, knn,
                     nslots)[None]


def _query_blocks(qb: int):
    """`_prop_step_batched` over the query nodes in sequential blocks of qb,
    in `_frame_loop`'s step signature: each block's affinity is
    (B, nslots*N, qb), so the peak is O(K*N*qb) instead of the (K*N, N)
    affinity of the whole frame. A query's winners and weighted sum read
    only its own affinity column, so each block's outputs are the
    unchunked step's; the last block is shorter and needs no padding."""

    def step(feats, query, mask, slot_bias, labels, temperature, knn, nslots):
        return torch.cat([
            _prop_step_batched(feats, query[:, i : i + qb], mask[:, i : i + qb], slot_bias,
                               labels, temperature, knn, nslots)
            for i in range(0, query.shape[1], qb)
        ], dim=1)

    return step


def _propagate(emb, seeds, mask, long_mem, cfg: LabelPropConfig, knn: int, kernel: str,
               qb: int | None = None):
    """soft (B, T, N, M) through the resolved kernel: 'torch' the plain
    batched loop (query blocks of qb when set), 'cuda' one prop_step launch
    per frame, radargram by radargram, 'cuda_seq' one prop_seq launch,
    'cuda_resident' one prop_all launch."""
    args = (long_mem, cfg.cxt_size, cfg.temperature, knn)
    if kernel == "cuda_seq":
        from .labelprop_cuda import prop_seq

        return prop_seq(emb, seeds, mask, *args)
    if kernel == "cuda_resident":
        from .labelprop_cuda import prop_all

        return prop_all(emb, seeds, mask, *args)
    if kernel == "cuda":
        return torch.cat([
            _frame_loop(emb[b : b + 1], seeds[b : b + 1], mask, *args, _cuda_step)
            for b in range(emb.shape[0])
        ])
    if qb is not None:
        return _frame_loop(emb, seeds, mask, *args, _query_blocks(qb))
    return propagate_seq_reference(emb, seeds, mask, *args)


@torch.no_grad()
def propagate_labels(
    emb, seed_labels, cfg: LabelPropConfig, grid_hw=None, kernel: str = "auto",
    device=None, query_block: int | None = None,
):
    """Propagate seed labels through a frame sequence.

    Args:
      emb: (T, N, C) L2-normalized per-node embeddings.
      seed_labels: (N, M) one-hot (or soft) labels of frame 0.
      cfg: LabelPropConfig.
      grid_hw: patch-grid shape per frame; default (N, 1), a vertical column
        of patches.
      kernel: 'torch' (plain step), 'cuda' (the per-frame kernel, one launch
        per frame), 'cuda_seq' (the whole-sequence kernel, one launch; the
        B = 1 view of `propagate_labels_batched`), 'cuda_resident' (the
        whole-sequence kernel with the TPU resident kernel's weight
        arithmetic, one launch) or 'auto': on a CUDA device with no
        query_block set, 'cuda_seq' where the call fits that kernel's limits
        (knn <= 256, the class count, shared memory), else 'cuda' where it
        fits that one's, else 'torch'; 'torch' on the CPU.
      device: where to run; default cuda (raises when CUDA is absent).
      query_block: plain route only; when set, each frame's query nodes run
        in sequential blocks of min(query_block, N), bounding the affinity
        to O(K*N*query_block) instead of (K*N, N). Each query's arithmetic
        is the unchunked step's (equal bit for bit wherever the affinity's
        dot products are exact; the BLAS may sum a narrow block's in
        another order). A CUDA kernel named with it raises.

    Returns:
      soft: (T, N, M) float32 soft labels per frame (frame 0 = the seed).
      pred: (T, N) int32 argmax labels (first maximum on ties).
    """
    emb = torch.as_tensor(emb, dtype=torch.float32)
    seed = torch.as_tensor(seed_labels, dtype=torch.float32)
    soft, pred = _propagate_labels(emb[None], seed[None], cfg, grid_hw, kernel, None,
                                   query_block, device)
    return soft[0], pred[0]


@torch.no_grad()
def propagate_labels_batched(
    emb, seed_labels, cfg: LabelPropConfig, grid_hw=None, kernel: str = "auto",
    batch_block: int | None = None, device=None, query_block: int | None = None,
):
    """Propagate B radargrams at once: emb (B, T, N, C), seed_labels
    (B, N, M) -> soft (B, T, N, M), pred (B, T, N) int32.

    kernel: as in `propagate_labels`: 'auto' is one launch of the
    whole-sequence kernel for the batch on a CUDA device ('cuda_resident'
    likewise launches `prop_all` once for the batch). 'cuda' runs the
    per-frame kernel radargram by radargram.

    batch_block: when set, the batch runs in chunks of this size (one
    launch per chunk under 'cuda_seq' and 'cuda_resident'), bounding the
    working set; a trailing partial chunk is padded with the first
    radargram and its outputs are dropped. The results equal the unchunked
    call. query_block: as in `propagate_labels`."""
    return _propagate_labels(emb, seed_labels, cfg, grid_hw, kernel, batch_block, query_block,
                             device)


def _propagate_labels(emb, seed_labels, cfg: LabelPropConfig, grid_hw, kernel: str,
                      batch_block, query_block, device):
    """The entry points' common body: the route, then the propagation in
    the span `crw.frames`, one span a call whatever the route."""
    device = resolve_device(device)
    emb = torch.as_tensor(emb, dtype=torch.float32, device=device).contiguous()
    seeds = torch.as_tensor(seed_labels, dtype=torch.float32, device=device).contiguous()
    B, T, N, C = emb.shape
    mask, long_mem = _validate_cfg(cfg, N, grid_hw, device)
    knn = min(cfg.knn, (len(long_mem) + cfg.cxt_size) * N)
    qb = None
    if query_block is not None:
        if int(query_block) < 1:
            raise ValueError(f"query_block must be >= 1, got {query_block}")
        qb = min(int(query_block), N)
    kernel = _route(kernel, device, query_block, T, N, seeds.shape[-1], knn, long_mem,
                    cfg.cxt_size)
    if batch_block is None:
        with span("crw.frames"):
            soft = _propagate(emb, seeds, mask, long_mem, cfg, knn, kernel, qb)
        return soft, soft.argmax(dim=-1).to(torch.int32)
    bb = int(batch_block)
    if bb < 1:
        raise ValueError(f"batch_block must be >= 1, got {batch_block}")
    bb = min(bb, B)
    n_chunks = -(-B // bb)
    pad = n_chunks * bb - B
    if pad:
        emb = torch.cat([emb, emb[:1].expand(pad, *emb.shape[1:])])
        seeds = torch.cat([seeds, seeds[:1].expand(pad, *seeds.shape[1:])])
    with span("crw.frames"):
        soft = torch.cat([
            _propagate(emb[i : i + bb], seeds[i : i + bb], mask, long_mem, cfg, knn, kernel, qb)
            for i in range(0, n_chunks * bb, bb)
        ])[:B]
    return soft, soft.argmax(dim=-1).to(torch.int32)
