"""The propagation pipeline: seed labels -> full radargram segmentation.

  1. (optional) time-flip for last-frame seeding (`use_last`),
  2. encode all T*N patches and L2-normalize,
  3. horizontality xent metric and its column diffs,
  4. host PELT change-point detection on that signal,
  5. nearest-resize the seed segmentation column to (N, 1), one-hot,
  6. frame-by-frame top-k label propagation over the ring buffer,
returning (prediction (N, T), xent (N, T-1), change_idx).

Follows radar_sounder_crw_tpu/infer/propagate.py (`PropagationPipeline`):
the single-radargram path, interactive `reseed`, and full-survey inference
over many radargrams (`propagate_survey`, on windows gathered on the device
from a once-uploaded radargram). Steps 2, 3 and 6 run on the pipeline's
device. On a GPU, 6 launches the whole-sequence CUDA kernel once per
seed->map, once per reseed and once per survey pass (kernel='auto'; a
named kernel runs on every path).

`bn_train_mode=True` normalizes with batch statistics, as the upstream test
scripts that never leave train mode do; the running statistics are left
untouched.

The survey path takes a `mesh` (parallel/mesh.py; default the process
group's when one is initialised, else the pipeline's device alone): the
radargram axis R is padded to a multiple of the mesh size, each rank
encodes and propagates its R / size radargrams (the route chosen for its
own batch, so the whole-sequence kernel launches once per rank and pass),
and the class maps, change signals and xent maps are gathered, so every
rank returns the whole result.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn

from ..models.resnet import frozen_statistics
from ..ops.labelprop import (
    LabelPropConfig,
    propagate_labels,
    propagate_labels_batched,
    resolve_kernel,
)
from ..ops.pelt import detect_change_point
from ..ops.xent_metric import column_diffs, horizontality_xent
from ..parallel.mesh import all_gather, default_mesh, pad_to_multiple, shard_batch
from ..utils.device import resolve_device
from ..utils.pos_embed import maybe_pos_embed
from ..utils.profiling import span
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
    saved = [m.training for m in bns]
    for m in bns:
        m.train()
    try:
        with frozen_statistics(model):
            yield
    finally:
        for m, training in zip(bns, saved):
            m.train(training)


@torch.no_grad()
def encode_sequence(model: nn.Module, seq: torch.Tensor, use_pos_embed: bool, bn_train_mode: bool):
    """(T, N, h, w) -> (T, N, C) L2-normalized embeddings, one batched
    encoder forward over the T*N patches (NCHW, pe channel first), in the
    span `crw.encode`."""
    T, N, H, W = seq.shape
    with span("crw.encode"):
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

    kernel: 'auto' (on a GPU the whole-sequence CUDA kernel, for one
    radargram and for a survey alike; the plain path on the CPU), 'torch',
    'cuda' (the per-frame kernel, one launch a frame), 'cuda_seq' or
    'cuda_resident' (see ops/labelprop.propagate_labels). A whole-sequence
    kernel launches once per seed->map, once per reseed and once per
    survey pass.
    device: default cuda; raises when CUDA is absent, so a CPU run must say
    device='cpu'."""

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
        resolve_kernel(kernel, self.device)  # refuses unknown or misplaced kernels
        self.kernel = kernel
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
        with span("crw.upload"):
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
        return_soft also returns the (T, N, M) soft-label history. The
        whole call runs in the span `crw.seed`."""
        with span("crw.seed"):
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
        change_idx None. The whole call runs in the span `crw.reseed`."""
        with span("crw.reseed"):
            pred, tail_len = self.reseed_device(seg_ref, frame_idx, bucket)
            cache = self._cache
            tail = pred[:tail_len].T.to(torch.int32).cpu().numpy()  # (N, T-f)
            full = cache["prediction"].copy()
            full[:, frame_idx:] = tail
            cache["prediction"] = full
            return PropagateResult(prediction=full, xent=cache["xent"], change_idx=None,
                                   soft=None)

    def prediction_to_pixels(self, prediction: np.ndarray, out_hw: tuple[int, int]):
        """Upsample the (N, T) patch-grid map to pixels (nearest), in the
        span `crw.assemble.to_pixels`. The pixel map is int8 where the
        classes fit it (nclasses <= 127, as the batched fetch), else int32:
        the small patch map is cast first, and the pixels are never widened."""
        with span("crw.assemble.to_pixels"):
            dtype = np.int8 if self.nclasses <= 127 else np.int32
            return resize_nearest(prediction.astype(dtype, copy=False), out_hw)

    @torch.no_grad()
    def _batched_body(self, seqs: torch.Tensor, seeds: torch.Tensor, compute_xent: bool,
                      return_xent: bool):
        """Encode + propagate (+ the change-point signal, + the xent maps)
        over the radargram axis R of seqs (R, T, N, h, w) on the device.

        At eval the encoder runs as ONE flat (R*T)-frame forward: running
        BatchNorm statistics and the per-embedding L2 make the radargram
        axis inert. Under bn_train_mode each radargram is encoded alone, so
        batch statistics never mix across radargrams, as in `__call__`.
        Compact (R, N) int seeds become a one-hot here."""
        if seeds.dim() == 2:
            seeds = torch.nn.functional.one_hot(seeds.long(), self.nclasses).float()
        R, T, N = seqs.shape[:3]
        if self.bn_train_mode:
            embs = torch.stack([
                encode_sequence(self.model, s, self.use_pos_embed, True) for s in seqs
            ])
        else:
            flat = seqs.reshape(R * T, N, *seqs.shape[3:])
            embs = encode_sequence(self.model, flat, self.use_pos_embed, False)
            embs = embs.reshape(R, T, N, -1)
        # 'auto' is the whole-sequence kernel here, one launch per pass
        _, pred = propagate_labels_batched(
            embs, seeds, self.lp_cfg, None, self.kernel, device=self.device
        )
        if seeds.shape[-1] <= 127:
            pred = pred.to(torch.int8)  # the class map fetch is the largest
        xents = None
        if compute_xent or return_xent:
            xents = horizontality_xent(embs, self.xent_tau, quirk_channel_shift=self.xent_quirk)
        sigs = column_diffs(xents) if compute_xent else None
        return pred, sigs, (xents if return_xent else None)

    @staticmethod
    def _gather(mesh, *outs):
        """Each rank's outputs (None stays None) gathered over the mesh."""
        if mesh.group is None:
            return outs
        return tuple(None if t is None else all_gather(t, mesh) for t in outs)

    def _fetch_batched(self, pred, sigs, xents, real, detect_change, return_xent):
        """The host tail of the survey path: fetch, keep the first `real`
        radargrams, per-radargram PELT on the batched signal."""
        preds = pred[:real].permute(0, 2, 1).to(torch.int32).cpu().numpy()  # (R, N, T)
        result = (preds,)
        if detect_change:
            if sigs is not None:
                sig_host = sigs[:real].cpu().numpy()
                change = [detect_change_point(s, pen=self.pelt_pen) for s in sig_host]
            else:
                change = [None] * real
            result += (change,)
        if return_xent:
            result += (xents[:real].cpu().numpy() if xents is not None else None,)
        return result if len(result) > 1 else preds

    def propagate_survey(
        self, source, window_ids, seg_refs, *, length: int | None = None,
        frame_offsets=None, mesh=None, use_last: bool = False, detect_change: bool = False,
        return_xent: bool = False,
    ):
        """Full-survey inference with windows gathered on the device: exactly
        `propagate_survey_device` plus the one host fetch.

        Returns (R, N, T) int32 predictions; with detect_change=True a tuple
        (predictions, change indices), the change detection running on the
        batched xent signal (device) and per-radargram PELT (host); with
        return_xent=True the (R, N, T-1) xent maps are appended last. Each
        radargram's result is what `__call__` computes on its window. The
        whole call, device work, fetch and PELT, runs in the span
        `crw.survey`."""
        with span("crw.survey"):
            pred, sigs, xents, real = self.propagate_survey_device(
                source, window_ids, seg_refs, length=length, frame_offsets=frame_offsets,
                mesh=mesh, use_last=use_last, detect_change=detect_change,
                return_xent=return_xent,
            )
            return self._fetch_batched(pred, sigs, xents, real, detect_change, return_xent)

    def propagate_survey_device(
        self, source, window_ids, seg_refs, *, length: int | None = None,
        frame_offsets=None, mesh=None, use_last: bool = False, detect_change: bool = False,
        return_xent: bool = False,
    ):
        """The device work of `propagate_survey` without the host fetch:
        returns ((B, T', N) device class map, change signals or None, xent
        maps or None, real), B = real, the number of windows, rounded up to
        the mesh size; every rank holds all B.

        The radargram(s) behind `source` are uploaded once (memoized on this
        pipeline) and every pass (forward, reverse, correction) gathers its
        windows on the device from that copy; per call only the window ids
        and the seeds cross to the device.

        source: RGWindows, ConcatWindows or SubsetWindows
          (`data.device_windows.resident_source`).
        window_ids: (B,) dataset indices, the space of `source[i]`.
        length: window length (correction buckets; default source.geo.length).
        frame_offsets: optional (B,) frame shifts applied after the index
          mapping: window i shifted by k frames starts at frame k of window
          i (frames and windows share the (w - ow) column stride), which is
          how the correction tails dataset[i][change_idx:] are gathered.
        mesh: the ranks to split the windows over (see the module docstring).
        use_last: seed the last frame (each window time-flipped on the
          device).
        detect_change / return_xent: as in `propagate_survey`."""
        from ..data.device_windows import gather_windows, resident_source

        rs = resident_source(source)
        if rs is None:
            raise TypeError(
                f"propagate_survey needs a resident-gatherable dataset "
                f"(RGWindows / ConcatWindows / SubsetWindows), got "
                f"{type(source).__name__}"
            )
        rg_host, geo, index_map = rs
        T = geo.length if length is None else int(length)

        ids = np.asarray(window_ids, dtype=np.int64)
        if ids.ndim != 1:
            raise ValueError(f"window_ids must be (B,), got shape {ids.shape}")
        if ids.size and (ids.min() < 0 or ids.max() >= len(index_map)):
            raise IndexError(f"dataset index out of range [0, {len(index_map)}) in {ids!r}")
        gather_ids = index_map[ids]  # (B,) or (B, 2) for stacked sources
        if frame_offsets is not None:
            off = np.asarray(frame_offsets, dtype=np.int64)
            if off.shape != (ids.shape[0],):
                raise ValueError(
                    f"frame_offsets must match window_ids shape {ids.shape}, got {off.shape}"
                )
            gather_ids = gather_ids.astype(np.int64)
            if gather_ids.ndim == 2:
                gather_ids[:, 1] += off
            else:
                gather_ids += off
        # bounds for THIS length while the ids are on the host; a stacked
        # source checks each pair against its own segment's width (the stack
        # is padded to the widest, which would admit windows that overrun a
        # narrower segment into zeros)
        win_col = gather_ids[:, 1] if gather_ids.ndim == 2 else gather_ids
        if gather_ids.ndim == 2 and gather_ids.shape[0] > 0:
            inner = getattr(source, "dataset", source)
            segments = getattr(inner, "datasets", None)
            if segments is None:
                raise TypeError(
                    f"propagate_survey: stacked source {type(inner).__name__} exposes no "
                    f"per-segment datasets, so window bounds cannot be validated against "
                    f"true segment widths"
                )
            widths = [d.rg.shape[1] for d in segments]
            nw_seg = np.array([geo.num_windows(T, W=int(w)) for w in widths])
            bad = (win_col < 0) | (win_col >= nw_seg[gather_ids[:, 0]])
            if bad.any():
                k = int(np.argmax(bad))
                raise IndexError(
                    f"gather window {int(win_col[k])} out of range "
                    f"[0, {int(nw_seg[gather_ids[k, 0]])}) for length={T} in segment "
                    f"{int(gather_ids[k, 0])}"
                )
        else:
            nw_t = geo.num_windows(T, W=rg_host.shape[-1])
            if win_col.size and (win_col.min() < 0 or win_col.max() >= nw_t):
                raise IndexError(
                    f"gather window index out of range [0, {nw_t}) for length={T} in "
                    f"{win_col!r}"
                )

        mesh = default_mesh(self.device) if mesh is None else mesh
        rg_dev = self._resident_radargram(rg_host)
        gather_ids, real = pad_to_multiple(gather_ids, mesh.size)
        seeds, _ = pad_to_multiple(self._stack_seed_labels(seg_refs, geo.nh), mesh.size)
        if mesh.group is not None:
            gather_ids, seeds = shard_batch(gather_ids, mesh), shard_batch(seeds, mesh)
        seqs = gather_windows(rg_dev, gather_ids, geo, T)
        if use_last:
            seqs = seqs.flip(1)
        pred, sigs, xents = self._batched_body(
            seqs, torch.as_tensor(seeds, device=self.device),
            compute_xent=detect_change and T >= 4, return_xent=return_xent,
        )
        return (*self._gather(mesh, pred, sigs, xents), real)

    def _stack_seed_labels(self, seg_refs, n_nodes: int) -> np.ndarray:
        """(R, N) compact int seed labels for the survey path; the one-hot
        is rebuilt on the device. np.eye (the single-radargram path) takes
        labels in [-M, M) with negatives wrapping, so negatives wrap here too
        and anything np.eye would refuse raises IndexError."""
        labels = np.stack(
            [seed_onehot_from_segmentation(sr, n_nodes, self.nclasses)[1] for sr in seg_refs]
        )
        C = self.nclasses
        if labels.size and (labels.min() < -C or labels.max() >= C):
            raise IndexError(
                f"seed labels must lie in [-{C}, {C}) (np.eye semantics); "
                f"got range [{labels.min()}, {labels.max()}]"
            )
        labels = np.where(labels < 0, labels + C, labels)
        return labels.astype(np.int8 if C <= 127 else np.int32)

    def _resident_radargram(self, rg_host: np.ndarray) -> torch.Tensor:
        """Upload `rg_host` once and reuse it across passes (forward,
        reverse, every correction bucket). The memo holds the host array
        itself and compares by identity: an id() key could alias a
        collected array's recycled address. The upload runs in the span
        `crw.upload`."""
        memo = getattr(self, "_rg_memo", None)
        if memo is not None and memo[0] is rg_host:
            return memo[1]
        with span("crw.upload"):
            rg_dev = torch.as_tensor(rg_host, dtype=torch.float32, device=self.device)
        self._rg_memo = (rg_host, rg_dev)
        return rg_dev
