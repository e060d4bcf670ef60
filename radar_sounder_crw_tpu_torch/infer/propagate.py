"""The propagation pipeline: seed labels -> full radargram segmentation.

  1. (optional) time-flip for last-frame seeding (`use_last`),
  2. encode all T*N patches and L2-normalize,
  3. horizontality xent metric and its column diffs,
  4. host PELT change-point detection on that signal,
  5. nearest-resize the seed segmentation column to (N, 1), one-hot,
  6. frame-by-frame top-k label propagation over the ring buffer,
returning (prediction (N, T), xent (N, T-1), change_idx).

Follows radar_sounder_crw_tpu/infer/propagate.py (`PropagationPipeline`,
single-radargram path and interactive `reseed`). Steps 2, 3 and 6 run on the
pipeline's device; 6 launches the CUDA propagation kernel once per frame
when that device is a GPU.

`bn_train_mode=True` normalizes with batch statistics, as the upstream test
scripts that never leave train mode do; the running statistics are left
untouched.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops.labelprop import LabelPropConfig, propagate_labels, resolve_kernel
from ..ops.pelt import detect_change_point
from ..ops.xent_metric import column_diffs, horizontality_xent
from ..utils.device import resolve_device
from ..utils.pos_embed import maybe_pos_embed
from ..utils.resize import resize_nearest


@dataclasses.dataclass
class PropagateResult:
    prediction: np.ndarray  # (N, T) int32 class map (patch grid)
    xent: np.ndarray | None  # (N, T-1) horizontality metric
    change_idx: int | None  # PELT change point (frame index) or None
    soft: np.ndarray | None  # (T, N, M) soft labels (only with return_soft)


@contextlib.contextmanager
def _batch_stats(model: nn.Module):
    """BatchNorm with batch statistics and NO running-stat update: the torch
    form of flax `apply(train=True, mutable=['batch_stats'])` with the
    updated collection discarded."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    saved = [(m.training, m.track_running_stats) for m in bns]
    for m in bns:
        m.train()
        m.track_running_stats = False
    try:
        yield
    finally:
        for m, (training, track) in zip(bns, saved):
            m.train(training)
            m.track_running_stats = track


@torch.no_grad()
def encode_sequence(model: nn.Module, seq: torch.Tensor, use_pos_embed: bool, bn_train_mode: bool):
    """(T, N, h, w) -> (T, N, C) L2-normalized embeddings, one batched
    encoder forward over the T*N patches (NCHW, pe channel first)."""
    T, N, H, W = seq.shape
    x = maybe_pos_embed(seq.reshape(T * N, 1, H, W), use_pos_embed)
    if bn_train_mode:
        with _batch_stats(model):
            out = model(x)
    else:
        out = model(x)
    emb = out.reshape(T, N, -1)
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp_min(1e-12)


def seed_onehot_from_segmentation(seg_ref: np.ndarray, n_nodes: int, nclasses: int):
    """Nearest-resize a seed segmentation patch to one label per node and
    one-hot it."""
    col = resize_nearest(np.asarray(seg_ref), (n_nodes, 1))
    labels = col[:, 0].astype(np.int32)
    return np.eye(nclasses, dtype=np.float32)[labels], labels


class PropagationPipeline:
    """An encoder + label-propagation config as a callable seed->map pipeline.

    kernel: 'auto' (the CUDA kernel on a GPU, the plain step on the CPU),
    'cuda' or 'torch' (see ops/labelprop.propagate_labels). device: default
    cuda; raises when CUDA is absent, so a CPU run must say device='cpu'."""

    def __init__(
        self,
        model: nn.Module,
        lp_cfg: LabelPropConfig,
        nclasses: int,
        use_pos_embed: bool = False,
        bn_train_mode: bool = False,
        xent_tau: float = 0.1,
        xent_quirk: bool = False,
        pelt_pen: float = 5.0,
        cache_embeddings: bool = True,
        kernel: str = "auto",
        device=None,
    ):
        self.device = resolve_device(device)
        self.kernel = resolve_kernel(kernel, self.device)
        self.model = model.to(self.device).eval()
        self.lp_cfg = lp_cfg
        self.nclasses = nclasses
        self.use_pos_embed = use_pos_embed
        self.bn_train_mode = bn_train_mode
        self.xent_tau = xent_tau
        self.xent_quirk = xent_quirk
        self.pelt_pen = pelt_pen
        # reseed() reuses the last __call__'s device embeddings; loops that
        # never reseed can turn the cache off to free them after each call
        self.cache_embeddings = cache_embeddings
        self._cache: dict | None = None

    def release_cache(self) -> None:
        """Drop the cached embeddings (frees their device memory)."""
        self._cache = None

    def encode(self, seq) -> torch.Tensor:
        seq = torch.as_tensor(seq, dtype=torch.float32, device=self.device)
        return encode_sequence(self.model, seq, self.use_pos_embed, self.bn_train_mode)

    def _propagate(self, emb: torch.Tensor, seed: np.ndarray):
        return propagate_labels(
            emb, seed, self.lp_cfg, None, self.kernel, device=self.device
        )

    @torch.no_grad()
    def propagate_device(
        self, seq, seg_ref, use_last: bool = False, compute_sig: bool = False,
        compute_xent: bool = True,
    ):
        """The seed->map device work without the host fetch: returns device
        tensors (soft, pred, xent, sig, emb), entries None when not computed."""
        seq = torch.as_tensor(seq, dtype=torch.float32, device=self.device)
        if use_last:
            seq = seq.flip(0)
        N = seq.shape[1]
        seed, _ = seed_onehot_from_segmentation(seg_ref, N, self.nclasses)
        emb = self.encode(seq)
        xent = (
            horizontality_xent(emb, self.xent_tau, quirk_channel_shift=self.xent_quirk)
            if (compute_xent or compute_sig)
            else None
        )
        soft, pred = self._propagate(emb, seed)
        sig = column_diffs(xent) if compute_sig else None
        if not compute_xent:
            xent = None
        return soft, pred, xent, sig, emb

    def __call__(
        self, seq, seg_ref, use_last: bool = False, detect_change: bool = True,
        return_soft: bool = False, fetch_xent: bool = True,
    ) -> PropagateResult:
        """seq: (T, N, h, w) host array or tensor; seg_ref: 2-D seed
        segmentation patch covering the first frame's pixels (the last
        frame's with use_last). Change detection runs only when
        detect_change and T >= 4. fetch_xent=False drops the xent metric;
        return_soft also returns the (T, N, M) soft-label history."""
        T = len(seq)
        compute_sig = detect_change and T >= 4
        soft, pred, xent, sig, emb = self.propagate_device(
            seq, seg_ref, use_last, compute_sig, compute_xent=fetch_xent
        )
        change_idx = None
        if compute_sig:
            change_idx = detect_change_point(sig.cpu().numpy(), pen=self.pelt_pen)
        result = PropagateResult(
            prediction=pred.T.to(torch.int32).cpu().numpy(),  # (N, T)
            xent=xent.cpu().numpy() if xent is not None else None,
            change_idx=change_idx,
            soft=soft.cpu().numpy() if return_soft else None,
        )
        if self.cache_embeddings:
            self._cache = {
                "emb": emb,
                "prediction": result.prediction,
                "xent": result.xent,
            }
        return result

    @torch.no_grad()
    def reseed_device(self, seg_ref, frame_idx: int = 0, bucket: int = 16):
        """The device work of `reseed` without the fetch/splice: returns
        ((padded, N) device class map, tail_len)."""
        cache = self._cache
        if cache is None:
            raise RuntimeError("reseed() needs a prior __call__ on this pipeline")
        emb = cache["emb"]
        T, N, _ = emb.shape
        if not 0 <= frame_idx < T:  # T-1 is legal: reseed just the last frame
            raise ValueError(f"frame_idx {frame_idx} out of range for T={T}")
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        seed, _ = seed_onehot_from_segmentation(seg_ref, N, self.nclasses)
        # the tail is zero-padded at the END to a multiple of `bucket`: the
        # frame loop only runs forward, so the real frames' outputs equal
        # the unbucketed run, and the pad frames' outputs are dropped
        tail_len = T - frame_idx
        padded = -(-tail_len // bucket) * bucket
        tail = emb[frame_idx:]
        if padded > tail_len:
            pad = emb.new_zeros((padded - tail_len, *emb.shape[1:]))
            tail = torch.cat([tail, pad])
        _, pred = self._propagate(tail, seed)
        return pred, tail_len

    def reseed(self, seg_ref, frame_idx: int = 0, bucket: int = 16) -> PropagateResult:
        """Interactive re-seeding: propagate a NEW seed from `frame_idx` on,
        reusing the cached embeddings of the last __call__ (no re-encode).

        Frames before `frame_idx` keep the CURRENT map (the first
        call's map as refined by earlier reseeds), so refinements
        accumulate. With use_last in the cached call, frame_idx counts
        flipped frames. Returns the spliced (N, T) map, the cached xent and
        change_idx None."""
        pred, tail_len = self.reseed_device(seg_ref, frame_idx, bucket)
        cache = self._cache
        tail = pred[:tail_len].T.to(torch.int32).cpu().numpy()  # (N, T-f)
        full = cache["prediction"].copy()
        full[:, frame_idx:] = tail
        cache["prediction"] = full
        return PropagateResult(prediction=full, xent=cache["xent"], change_idx=None, soft=None)

    def prediction_to_pixels(self, prediction: np.ndarray, out_hw: tuple[int, int]):
        """Upsample the (N, T) patch-grid map to pixels (nearest)."""
        return resize_nearest(prediction.astype(np.int32), out_hw)
