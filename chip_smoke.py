"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. build every CUDA source the port registers (ops/cuda_build.py): the
     three propagation kernels, csrc/prop_step.cu, csrc/prop_seq.cu and
     csrc/prop_all.cu, all on the tile core csrc/prop_tile.cuh, the last
     two on the all-frames kernels of csrc/prop_frames.cuh, and the
     train-mode BatchNorm kernels of csrc/bn_train.cu (sm_90a, one nvcc
     each, started together);
  2. hold prop_step against its plain PyTorch twin at MC3 and SHARAD step
     shapes, the MC3 prefixes of frames t = 1, 2, 37 and 100, a tie-heavy
     case (bit for bit), knn above the candidate count, an odd channel
     count and N = 400 (seven query tiles): pred to 1e-4 absolute, argmax
     exactly equal; then its first step's chunk lists against the twin's
     (`_chunk_lists`) on the tie-heavy case, exactly;
  3. MC3 seed->map at full width (ResNet-10 float32, TF32 off) on a
     synthetic 410 x 3200 radargram, one 32x32 window with overlap (30, 0):
     T = 100 frames of N = 190 nodes, seeded from the first 32 columns,
     change detection on, then one reseed at frame 40; the main path
     (kernel="auto": one prop_seq launch for the seed->map, one for the
     reseed, no prop_step) and kernel="cuda" by name (one prop_step launch
     a frame) each against the plain path: >= 99.5 % equal maps, equal
     change_idx;
  4. times on the card: encode, propagate, seed->map and reseed wall ms on
     the main path and on kernel="cuda", prop_step per launch and per
     seed->map of kernel="cuda" (CUDA events around eager
     calls; per launch also device-only, 50 calls in one CUDA graph), split
     into its tile and merge steps, with the share of the bound, the plain step,
     one torch.matmul of the same affinity product as a yardstick, and the
     host's share of a prop_step call (wall per call of the 99-call loop
     minus its device time per call, read with every launch queued behind
     a long matmul);
  5. hold prop_seq against its plain twin (the batched frame loop) at the
     Miguel survey shape (B = 63, T = 100, N = 50), at MC3 width (N = 190),
     on a wrapping ring with pins, with knn above the candidate count, on
     tie-heavy dyadic values, and at T = 1 (no launch): soft to 1e-4
     absolute, argmax exactly equal (bit for bit on the grid and dyadic
     cases); phase A's winner lists against `_winners_all_frames` on the
     tie-heavy case, exactly; then cuda_seq (B = 1) against the
     per-frame cuda path on the MC3 window: >= 99.5 % equal maps;
  6. hold prop_all bit for bit against its plain twin
     (propagate_all_reference) at the same shapes plus an empty long_mem,
     one launch per case (none at T = 1), and against prop_seq at the survey
     shape (soft to 1e-5, >= 99.5 % equal maps); its row-ordered weight
     lists against `_weights_all_frames` on the wrapping ring with pins and
     the tie-heavy case, exactly; then MC3 seed->map and
     reseed through PropagationPipeline(kernel="cuda_resident"): one
     prop_all launch each, >= 99.5 % equal maps with the cuda path, equal
     change_idx, wall times;
  7. the Miguel survey at full width, as `cli.test_all --correction
     --correction_tail --use_last` runs it: 63 windows of
     T = 100 frames, N = 50, of the synthetic 410 x 105120 line; forward
     with change detection, the correction tails bucketed by length, the
     reverse pass and the flat MCORDS3 merge. On every pass the
     whole-sequence kernel route against the plain route: >= 99.5 % equal
     maps, equal change indices; the forward survey against one
     `__call__` a window (>= 99.5 % equal maps, equal change indices, the
     differing entries printed); prop_seq launched once per
     survey call and once per correction bucket; then every pass through
     kernel="cuda_resident": one prop_all launch each, >= 99.5 % equal maps
     with cuda_seq;
  8. survey times: wall ms and radargrams/s (median of 5), the encode of
     the 315,000 patches, prop_seq per launch split into phase A (every
     frame's winners) and phase B (the label chain), and prop_all per
     launch split into the selection, the weight epilogue and the chain,
     against their bound (prop_all also at MC3, B = 1; the selection there
     at B = 1 and B = 4), the plain twins, the plain and the
     per-frame-kernel survey propagation, a batched torch.bmm of the
     saturated affinity product as a yardstick, and the device's busy time
     by kernel over one survey call (torch.profiler);
  9. auto_limits: propagate_labels_batched under kernel="auto" with
     knn = 300, above every kernel's limit, on a small survey shape: it
     resolves to the plain route before any launch (no launch counted), its
     maps equal the CPU plain route's, and the same call with a kernel named
     ("cuda_seq", "cuda") raises ValueError;
 10. cli: the user's own command at full width,
     `python -m radar_sounder_crw_tpu_torch.cli.test_all --dataset 1
     --model 1 --correction --use_last --no_plots
     --allow_untrained` (the synthetic Miguel line, seq_length 100, 16x16
     patches, overlap (8, 0), cxt 100, radius 10, temperature 0.1, knn 20),
     once through the launcher `bash radar_sounder_crw_tpu_torch/launch/
     launch_test.sh` (this interpreter first on PATH as `python3`) and once
     directly with --kernel torch: exit 0, `mIoU:` printed,
     >= 99.5 % equal predicted maps, each run's wall time; then the
     launcher's arguments through cli.test_all.main in this process for the
     launches of the default route, prop_seq once per survey call (forward,
     each correction bucket, reverse), as many survey calls as the
     launcher's run printed correction buckets, plus two;
 11. annotate: `python -m radar_sounder_crw_tpu_torch.cli.annotate
     --dataset 3 --allow_untrained` over stdin: load window 0, seed from the
     ground truth, reseed at frame 40, metrics, info, quit; every reply ok,
     the seed's and the reseed's wall ms; then the same session in this
     process for its launches (one prop_seq each for the seed and the
     reseed, no prop_step);
 11b. route_b1: one radargram's propagation under kernel="auto" (one
     prop_seq launch a call) against kernel="cuda" (one prop_step launch a
     frame) at T in (2, 16, 57, 112) x N in (50, 113, 190), the cells' cxt
     100, knn 20 and radius 10, M = 6, on grid inputs: maps equal bit for
     bit, then per call the elapsed ms of CUDA events around 20 calls and
     the host's wall ms (median of 20 synchronized calls), each after a
     warm-up; the table in chiprun_out/route_b1.json;
 12. train_vs_cpu: the CRW trainer (float32, TF32 off) on the card
     against the same trainer on the CPU, one init, one batch schedule
     (B = 2, T = 5, N = 6): one ResNet-10 step with the two-pass batch
     variance (the loss within rtol 5e-5) and the one-pass default (5e-4),
     the running means within rtol 1e-3; then the CNN's 12 steps, each loss
     within relative 5e-6 for the first 4 and 2e-4 throughout (the CPU
     tests' tolerances; the ResNet's later steps are printed, not held);
 12b. bn_kernels: the four BatchNorm kernels of csrc/bn_train.cu (stats,
     apply, backward reduce, dx; models/fused_bn.py's `fused`) at the 13
     BatchNorm shapes of the bench configuration's step (18,080 patches),
     float32 and bfloat16, each against its plain twin (sums bit for bit on
     2**-5-grid inputs, within relative 1e-5 of the sums of magnitudes on
     real ones; mean and var bit for bit; y and dx within 2 ulp given the
     same sums; stats, apply and backward_reduce repeat their bits on a
     second call), then
     each one's device time (CUDA events around 10 eager calls) beside its
     twin's, one PyTorch call of the same function and its bound, and
     F.batch_norm(training=True) forward and backward; and the device-only
     time of each kernel and library call (10 calls in one CUDA graph,
     each on another copy of its inputs, the replays timed: neither the
     host's launch work nor the L2 cache sets it) with its bound share,
     and of torch.sum over all of x and a copy of x as yardsticks of a
     read and a read-and-write; fails if the backward reduce, device-only,
     is slower than native_batch_norm_backward's parameter gradients at any
     shape in either dtype;
 13. crw_step: CRW train steps at bench.py's configuration (B = 8, T = 20,
     16x16, overlap (8, 0), synthetic SHARAD 912 x 4096 seed 13, N = 113),
     the batch gathered once on the card, float32 and bfloat16, with
     fused_bn None, 'fused' and 'lean', each with steps_per_dispatch 1 and
     8 (float32 at 8 with None alone): median ms a step (CUDA events),
     steps/s, peak memory, the device's idle share and largest kernels
     under torch.profiler (over three bfloat16 steps, one float32 step or
     one replay of eight), the BatchNorm kernels' launches (13 a step for
     each of `fused`'s, 13 of the statistics for `lean`) and the graph
     replays; for fused_bn None at k = 1 also the matmul and convolution
     operations against the peak of their dtype and the step with cuDNN
     choosing its algorithms by timing them (cudnn.benchmark; a
     measurement, not the port's default);
 13b. graph_vs_eager: steps_per_dispatch 8 at the bench configuration in
     bfloat16, cuDNN deterministic, flax's BatchNorm and `fused`: two
     chunks (eager, then one graph replay) against 16 eager steps, bit for
     bit (losses, parameters and buffers, Adam's state);
 14-15. train_cli: `python -m radar_sounder_crw_tpu_torch.cli.train
     --dataset 3 --model 1 --no_plots` at its defaults (synthetic SHARAD
     912 x 8192, 2 epochs of 62 steps), through the launcher
     `launch/launch_train.sh` as in 10, then directly with --bf16, then
     with --bf16 --steps_per_dispatch 8: exit 0, two epoch lines,
     `Finished training.`, the wall time;
 15b. launch: the sweep launchers `launch/launch_test_batch.sh` (27 runs of
     cli.test_all over radius x temp x knn) with 10's arguments and
     `launch/launch_train_batch.sh` (81 runs of cli.train over seq_length x
     lr x tau x overlap) with `--dataset 3 --model 1 --no_plots --epochs
     1`, each with a `python3` first on PATH that runs its first call on
     the card and records the others: exit 0, exactly 27 and 81 calls, the
     first at radius 5, temp 0.01, knn 5 printing `mIoU:`, the first at
     seq_length 10, lr 1e-2, tau 1e-1, overlap 8 0 printing a finite epoch
     loss and `Finished training.` and writing
     models/crw_s10_lr1e-2_tau1e-1_ov8_0.pt; each first run's wall time;
 16. trained_inference: each trained `.pt` loaded strict and run through
     seed->map on SHARAD window 0 (T = 100, N = 113) on the default route
     (one prop_seq launch) and the plain route: >= 99.5 % equal maps,
     equal change indices, the mIoU against the synthetic ground truth;
 17-18. unet: UNet steps at scripts/test_unet.py's width and batch (64
     strips of 912 x 64, 5 classes), float32 and bfloat16, measured as in
     13; then `python -m radar_sounder_crw_tpu_torch.cli.test_unet --epochs
     5`, float32 and --bf16 (the script's 100 epochs cut to 5 to keep the
     run short): exit 0, `mIoU:`, ms a step from the epoch times;
 19. tune: `RSCRW_SYNTH_SCALE=4 python -m radar_sounder_crw_tpu_torch.cli.train
     --tune --tune_samples 4 --tune_ckpt_dir <dir>` at the tuner's defaults
     (dataset 0, its synthetic 410 x 27330 line cut to 410 x 6832, the cut a
     cut of length only; ResNet-10 at full width, T = 8, 32x32 patches, the
     reference grid, max_t 3: seven trial-epochs), then the same command
     again: it resumes with every rung done, trains nothing (the sweep
     ledger unchanged, only the last rung's line, read back) and reports
     the same best trial; both walls and each trial's epoch times;
 20. data_parallel: `python -m torch.distributed.run --standalone
     --nproc_per_node 1 chip_smoke.py --data-parallel-rank nccl`: three
     CRWTrainer steps at bench.py's configuration on `make_mesh()` (NCCL,
     world 1, every collective issued) and on the device alone, cuDNN
     deterministic: losses and parameters exactly equal, ms a step of both;
     the Miguel survey's forward pass with change detection through
     `propagate_survey(mesh=...)` and without: maps and change indices
     exactly equal, one prop_seq launch each; steps_per_dispatch 2 on the
     mesh (bfloat16, fused_bn='fused': the BatchNorm sums' and gradients'
     all-reduces captured in the graph) bit-equal to eager steps. Then the
     same with two ranks on the one card over gloo carrying CUDA tensors
     (NCCL refuses two ranks on one device), held as
     tests/test_torch_parallel.py holds two ranks: the first step's loss
     within rtol 1e-5 and its running statistics within rtol 1e-5 / atol
     1e-6, the ranks' states equal, the survey's maps exactly equal, and
     steps_per_dispatch 2 refused (gloo cannot be captured);
 21. a JSON line describing each kernel (with the training phases' numbers
     under `train_times`, the data-parallel runs under `data_parallel`),
     the card's name and power limit, and the final {"ok": true, ...} line.

Launch counts are set to 0 just before each path is driven and read just
after it: the default main path (phases 3 and 7), the cuda_resident one,
the auto_limits call, the two entry points of phases 10 and 11, each
trained encoder's seed->map in phase 16 and each survey call of phase 20
(one prop_seq launch a rank and call), and for the BatchNorm kernels each
timed run of phase 13 (the main path: 20 bfloat16 steps with
fused_bn='fused'). A CUDA graph's replay runs its kernels without calling
their wrappers: phase 13 counts the replays beside the launches. The other
training phases launch none of the port's kernels: their work runs in
cuDNN and PyTorch's own kernels. Commands run as processes of their own
(the CLIs and launchers of phases 10, 11, 14-15, 15b, 18-19) count in
those processes, which this one cannot read: phases 10 and 11 repeat
their command in this process for its launches.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import os
import shlex
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

import numpy as np
import torch

PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
STEP_ATOL = 1e-4  # pred is a convex mix of labels in [0, 1]: summation order only
MAP_AGREEMENT = 0.995


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def reset_launches():
    """Every kernel's launch count to 0."""
    from radar_sounder_crw_tpu_torch.ops import bn_cuda, labelprop_cuda

    for counts in (labelprop_cuda.launches, bn_cuda.launches):
        for name in counts:
            counts[name] = 0


def cuda_ms(fn, iters=20, warmup=3):
    """Device time per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, reps=5):
    """Median host wall time of fn() followed by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_inputs(K, N, C, M, radius, nslots, seed, ties=False):
    from radar_sounder_crw_tpu_torch.ops.labelprop import NEG_INVALID, radius_mask

    rng = np.random.default_rng(seed)
    if ties:  # dyadic values: every dot product is exact, ties are real
        feats = rng.integers(-2, 3, (K, N, C)).astype(np.float32) / 2
        query = rng.integers(-2, 3, (N, C)).astype(np.float32) / 2
    else:
        feats = rng.standard_normal((K, N, C)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        query = rng.standard_normal((N, C)).astype(np.float32)
        query /= np.linalg.norm(query, axis=-1, keepdims=True)
    labels = rng.random((K, N, M)).astype(np.float32)
    valid = (rng.random(K) < 0.9) & (np.arange(K) < nslots)
    valid[min(1, nslots - 1)] = True
    bias = np.where(valid, 0.0, NEG_INVALID).astype(np.float32)
    mask = radius_mask(N, 1, radius)
    dev = torch.device("cuda")
    return [torch.as_tensor(a, device=dev) for a in (feats, query, mask, bias, labels)]


def step_flops_bytes(K, N, C, M, knn, nslots):
    """float32 operations (dot products, mask/bias/temperature, weighted
    sum; the selection's compares are not counted) and bytes (each input
    read once, the output written once) of one step."""
    ops = 2 * nslots * N * N * C + 3 * nslots * N * N + 2 * N * knn * M
    nbytes = 4 * (nslots * N * C + N * C + N * N + K + nslots * N * M + N * M)
    return ops, nbytes


def seq_flops_bytes(B, T, N, C, M, knn, L, cxt):
    """float32 operations and bytes of one whole-sequence launch: the step
    count of `step_flops_bytes` summed over every radargram's frames, each
    over its valid prefix ns = L + min(t, cxt); bytes are the embeddings,
    seeds and mask read once and the soft labels written once."""
    ops = B * sum(step_flops_bytes(L + cxt, N, C, M, knn, L + min(t, cxt))[0]
                  for t in range(1, T))
    nbytes = 4 * (B * T * N * C + B * N * M + N * N + B * T * N * M)
    return ops, nbytes


def bound(ops, nbytes):
    """(ms, what bounds it) at the card's float32 and memory peaks."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def seq_inputs(B, T, N, C, M, seed, ties=False):
    """Embeddings on a 2**-5 grid (dyadic halves with ties=True): every dot
    product is exact in any summation order, so the kernel and the twin
    select the same winners frame after frame; seeds are random soft labels."""
    rng = np.random.default_rng(seed)
    if ties:
        emb = rng.integers(-2, 3, (B, T, N, C)).astype(np.float32) / 2
    else:
        emb = rng.standard_normal((B, T, N, C)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        emb = np.round(emb * 32) / 32
    seeds = rng.random((B, N, M)).astype(np.float32)
    return torch.as_tensor(emb, device="cuda"), torch.as_tensor(seeds, device="cuda")


def device_busy(fn, warm=True):
    """Device time by kernel name over one call of fn under torch.profiler
    (after one call outside it, unless fn is warm already): the device's
    busy share of the call's wall time and the largest kernels (ms). A trace
    without device time reports a busy share of 0."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():  # the kernels themselves, not the ops that launch them
        us = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((us, ev.key))
    rows.sort(reverse=True)
    busy = sum(us for us, _ in rows)
    phase("profile", f"device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall; top: "
          + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms" for us, name in rows[:8]))
    return {"profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us}


def resident_split_ms(args, prefix):
    """prop_all's steps at one shape (CUDA events): the selection alone
    (prop_seq's phase A: the same kernel without the weight epilogue), the
    epilogue (prop_all's first launch minus that selection, a difference of
    two timed calls) and the weights-only chain."""
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda

    emb, seeds, mask, *rest = args
    select_ms = cuda_ms(lambda: labelprop_cuda.prop_seq_select(emb, mask, *rest), iters=10,
                        warmup=2)
    fused_ms = cuda_ms(lambda: labelprop_cuda.prop_all_weights(emb, mask, *rest), iters=10,
                       warmup=2)
    lists = labelprop_cuda.prop_all_weights(emb, mask, *rest)
    chain_ms = cuda_ms(lambda: labelprop_cuda.prop_all_chain(*lists, seeds), iters=10, warmup=2)
    return {f"{prefix}_select_ms": select_ms, f"{prefix}_weights_ms": fused_ms - select_ms,
            f"{prefix}_chain_ms": chain_ms}


MIGUEL_T, MIGUEL_PATCH, MIGUEL_OVERLAP = 100, (16, 16), (8, 0)


def miguel_survey():
    """The Miguel survey's dataset (the synthetic 410 x 105120 line), its 63
    window ids, seed patches, ground truth and class count."""
    from radar_sounder_crw_tpu_torch.data import create_dataset, get_reference

    T, patch = MIGUEL_T, MIGUEL_PATCH
    ds = create_dataset(id=1, length=T, dim=patch, overlap=MIGUEL_OVERLAP, full=True)
    geo = ds.geo
    nclasses, seg = get_reference(id=1, h=geo.nh * patch[0], w=0, length=T, dim=patch)
    rg_len, rg_h = geo.rg_len(), geo.rg_h()
    R = seg.shape[-1] // rg_len
    seg = seg[:, : R * rg_len]
    ids = list(range(0, len(ds), T))[:R]
    refs = [seg[:rg_h, rg_len * t : rg_len * t + patch[1]] for t in range(R)]
    if (R, geo.nh, len(ids)) != (63, 50, 63):
        raise SystemExit(f"survey geometry R={R} N={geo.nh} windows={len(ids)}, expected "
                         "63/50/63")
    return ds, ids, refs, seg, nclasses


def survey_phase(smi):
    """Phases 7 and 8: the full-width Miguel survey through the product
    entry point, on the whole-sequence kernels and on the plain route.
    Returns (launches by kernel on the survey's main path, launches by
    kernel on the cuda_resident path, what bounds the whole-sequence
    kernels, times)."""
    from radar_sounder_crw_tpu_torch.infer import (
        PropagationPipeline,
        correction_pixel_offset,
        integrate_flat_mcords3,
        reverse_unfold_flip,
        splice_correction,
    )
    from radar_sounder_crw_tpu_torch.models import create_model
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
    from radar_sounder_crw_tpu_torch.ops.labelprop import (
        LabelPropConfig,
        propagate_all_reference,
        propagate_labels_batched,
        propagate_seq_reference,
        radius_mask,
    )

    T, patch, overlap = MIGUEL_T, MIGUEL_PATCH, MIGUEL_OVERLAP
    t0 = time.perf_counter()
    ds, ids, refs, seg, nclasses = miguel_survey()
    geo = ds.geo
    N = geo.nh
    rg_len = geo.rg_len()
    R = len(ids)
    phase("survey", f"Miguel line {ds.rg.shape} -> {R} windows of T={T}, N={N} "
          f"(set-up {time.perf_counter() - t0:.1f} s)")
    cfg = LabelPropConfig(cxt_size=100, radius=10, temperature=0.1, knn=20)
    model = create_model(1, False, device="cuda", seed=0)
    pipe = PropagationPipeline(model, cfg, nclasses, cache_embeddings=False)
    plain = PropagationPipeline(model, cfg, nclasses, kernel="torch", cache_embeddings=False)
    per_frame = PropagationPipeline(model, cfg, nclasses, kernel="cuda", cache_embeddings=False)
    resident = PropagationPipeline(model, cfg, nclasses, kernel="cuda_resident",
                                   cache_embeddings=False)
    pipe.propagate_survey(ds, ids[:2], refs[:2])  # warm-up: upload, cuDNN choice
    torch.cuda.synchronize()
    seg_rev = reverse_unfold_flip(seg, rg_len)
    rev_refs = [seg_rev[:, rg_len * t : rg_len * t + patch[1]] for t in range(R)]

    def to_px(pred):
        return pipe.prediction_to_pixels(pred, (seg.shape[0], rg_len))

    def check(name, got, want, ch_got=None, ch_want=None, route="cuda_seq vs plain"):
        agree = float((got == want).mean())
        ok = agree >= MAP_AGREEMENT and ch_got == ch_want and got.shape == want.shape
        phase("survey", f"{name}: {route} map agreement={agree:.5f}"
              + ("" if ch_got is None else f", change indices equal={ch_got == ch_want}"))
        if not ok:
            raise SystemExit(f"survey pass {name}: {route} disagree")

    def run_passes(p, buckets=None):
        """Forward with change detection, the correction tails bucketed by
        length (from this forward unless given), reverse. Returns the maps,
        the change indices, the buckets and the launches of each pass (all
        kernels)."""
        per_pass = []

        def launched():
            torch.cuda.synchronize()
            total = sum(labelprop_cuda.launches.values())
            per_pass.append(total - sum(per_pass))

        fwd, change = p.propagate_survey(ds, ids, refs, detect_change=True)
        launched()
        if buckets is None:
            buckets = {}
            for t, ci in enumerate(change):
                if ci is None or ci >= T - 1:
                    continue
                small = T - ci
                off = correction_pixel_offset(small, patch[1], overlap[1])
                c0 = rg_len * t + rg_len - off
                buckets.setdefault(small, []).append((t, off, small, ci, seg[:, c0 : c0 + patch[1]]))
        corrected = {}
        for small, group in sorted(buckets.items()):
            corrected[small] = p.propagate_survey(
                ds, [ids[g[0]] for g in group], [g[4] for g in group], length=small,
                frame_offsets=[g[3] for g in group])
            launched()
        rev = p.propagate_survey(ds, ids, rev_refs, use_last=True)
        launched()
        return fwd, change, buckets, corrected, rev, per_pass

    # the main path: forward, correction buckets, reverse --------------------
    reset_launches()
    preds, change, buckets, corrected, rev_preds, per_pass = run_passes(pipe)
    main_launches = dict(labelprop_cuda.launches)
    n_tails = sum(len(g) for g in buckets.values())
    want_launches = 2 + len(buckets)
    phase("survey", f"main path: launches {main_launches}, per pass {per_pass} (expected "
          f"prop_seq {want_launches}, one per pass: forward, {len(buckets)} correction "
          f"buckets of {n_tails} tails, reverse)")
    if main_launches["prop_seq"] != want_launches or per_pass != [1] * want_launches:
        raise SystemExit("the survey did not launch prop_seq once per survey call")

    seg_list = [to_px(p) for p in preds]
    for small, group in buckets.items():
        for (t, off, _, _, _), pred in zip(group, corrected[small]):
            seg_list[t] = splice_correction(seg_list[t], pred, off)
    final = np.concatenate(seg_list, axis=1).ravel()
    rev_map = reverse_unfold_flip(np.concatenate([to_px(p) for p in rev_preds], axis=1), rg_len)
    final = integrate_flat_mcords3(final, rev_map)
    acc = float((final == seg.ravel()).mean())

    # the same passes on the plain route ------------------------------------
    ref_preds, ref_change, _, ref_corrected, ref_rev, _ = run_passes(plain, buckets)
    check("forward", preds, ref_preds, change, ref_change)
    for small, group in sorted(buckets.items()):
        check(f"correction T'={small} ({len(group)} tails)", corrected[small],
              ref_corrected[small])
    check("reverse", rev_preds, ref_rev)
    # the survey against its per-radargram form, one __call__ a window
    calls = [pipe(ds[i], r) for i, r in zip(ids, refs)]
    one_by_one = np.stack([c.prediction for c in calls])
    phase("survey", f"forward: survey vs per-radargram __call__ differing entries "
          f"{int((one_by_one != preds).sum())} of {preds.size}")
    check("forward", preds, one_by_one, change, [c.change_idx for c in calls],
          route="survey vs per-radargram __call__")
    checks = {
        "prediction shape": preds.shape == (R, N, T),
        "merged map shape": final.shape == (seg.size,),
        "classes in range": 0 <= final.min() and final.max() < nclasses,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"survey checks failed: {failed}")
    phase("survey", "ok: " + ", ".join(checks)
          + f"; merged map accuracy vs ground truth {acc:.4f} (random weights)")

    # every pass through the resident kernel, one prop_all launch each ------
    reset_launches()
    res_preds, res_change, _, res_corrected, res_rev, res_per_pass = run_passes(resident, buckets)
    resident_launches = dict(labelprop_cuda.launches)
    phase("survey", f"cuda_resident path: launches {resident_launches}, per pass "
          f"{res_per_pass} (expected prop_all {want_launches}, one per pass)")
    if (resident_launches["prop_all"] != want_launches
            or res_per_pass != [1] * want_launches):
        raise SystemExit("the survey did not launch prop_all once per survey call")
    route = "cuda_resident vs cuda_seq"
    check("forward", res_preds, preds, res_change, change, route=route)
    for small, group in sorted(buckets.items()):
        check(f"correction T'={small} ({len(group)} tails)", res_corrected[small],
              corrected[small], route=route)
    check("reverse", res_rev, rev_preds, route=route)

    # 8. times ------------------------------------------------------------------
    seqs = torch.as_tensor(np.stack([ds[i] for i in ids]), device="cuda")
    seeds = torch.nn.functional.one_hot(
        torch.as_tensor(pipe._stack_seed_labels(refs, N), device="cuda").long(), nclasses).float()
    torch.cuda.reset_peak_memory_stats()
    emb = pipe.encode(seqs.reshape(R * T, N, *patch)).reshape(R, T, N, -1)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mask = torch.as_tensor(radius_mask(N, 1, cfg.radius), device="cuda")
    knn, C = cfg.knn, emb.shape[-1]
    args = (emb, seeds, mask, (0,), cfg.cxt_size, cfg.temperature, knn)
    kernel_ms = cuda_ms(lambda: labelprop_cuda.prop_seq(*args), iters=5, warmup=1)
    # its two phases apart: every frame's winners, then the label chain
    select_args = (emb, mask, (0,), cfg.cxt_size, cfg.temperature, knn)
    phase_a_ms = cuda_ms(lambda: labelprop_cuda.prop_seq_select(*select_args), iters=5, warmup=1)
    lists = labelprop_cuda.prop_seq_select(*select_args)
    phase_b_ms = cuda_ms(lambda: labelprop_cuda.prop_seq_chain(*lists, seeds), iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: propagate_seq_reference(*args), iters=2, warmup=1)
    resident_ms = cuda_ms(lambda: labelprop_cuda.prop_all(*args), iters=5, warmup=1)
    resident_plain_ms = cuda_ms(lambda: propagate_all_reference(*args), iters=2, warmup=1)
    K = 1 + cfg.cxt_size
    fk = torch.randn((R, K * N, C), device="cuda")
    bmm_ms = cuda_ms(lambda: torch.bmm(fk, emb[:, 1].transpose(1, 2)), iters=50)
    ops, nbytes = seq_flops_bytes(R, T, N, C, nclasses, knn, 1, cfg.cxt_size)
    bound_ms, bound_by = bound(ops, nbytes)
    times = {
        "survey_ms": wall_ms(lambda: pipe.propagate_survey(ds, ids, refs)),
        "encode_ms": wall_ms(lambda: pipe.encode(seqs.reshape(R * T, N, *patch))),
        "prop_seq_ms_per_launch": kernel_ms,
        "prop_seq_phase_a_ms": phase_a_ms,
        "prop_seq_phase_b_ms": phase_b_ms,
        "prop_seq_bound_ms": bound_ms,
        "prop_seq_bound_share": bound_ms / kernel_ms,
        "prop_seq_phase_a_bound_share": bound_ms / phase_a_ms,
        "plain_propagation_ms": wall_ms(
            lambda: propagate_labels_batched(emb, seeds, cfg, kernel="torch"), reps=3),
        "cuda_per_frame_propagation_ms": wall_ms(
            lambda: propagate_labels_batched(emb, seeds, cfg, kernel="cuda"), reps=3),
        "cuda_seq_propagation_ms": wall_ms(
            lambda: propagate_labels_batched(emb, seeds, cfg, kernel="cuda_seq")),
        "plain_twin_ms": plain_ms,
        "prop_all_ms_per_launch": resident_ms,
        "prop_all_bound_share": bound_ms / resident_ms,
        "prop_all_plain_twin_ms": resident_plain_ms,
        **resident_split_ms(args, "prop_all"),
        "survey_resident_ms": wall_ms(lambda: resident.propagate_survey(ds, ids, refs)),
        "affinity_bmm_ms": bmm_ms,
        "survey_per_frame_kernel_ms": wall_ms(
            lambda: per_frame.propagate_survey(ds, ids, refs), reps=3),
        "survey_plain_ms": wall_ms(lambda: plain.propagate_survey(ds, ids, refs), reps=3),
    }
    times["survey_rg_per_s"] = R / (times["survey_ms"] / 1e3)
    times.update(device_busy(lambda: pipe.propagate_survey(ds, ids, refs)))
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in times.items())
          + f" | prop_seq and prop_all GFLOP={ops / 1e9:.2f} MB={nbytes / 1e6:.1f} bound by "
          + f"{bound_by} | encode peak memory {peak_gb:.2f} GB")
    return main_launches, resident_launches, bound_by, times


ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
LAUNCH = ROOT / "radar_sounder_crw_tpu_torch" / "launch"
CLI_ARGS = ["--dataset", "1", "--model", "1", "--correction", "--use_last", "--no_plots",
            "--allow_untrained"]


@contextlib.contextmanager
def launcher_env(record=False):
    """The environment to run a launcher of radar_sounder_crw_tpu_torch/launch/
    in: first on PATH, in a directory under OUT (the checkout, not a TMPDIR
    that may forbid execution), a `python3` that execs this interpreter (a
    script, not a symlink: a symlink outside a venv loses the venv). With
    `record`, every call appends its argv to a file, one line a call, and
    only the first call runs; the others exit 0. Yields (env, that file)."""
    OUT.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as bin_dir:
        calls = Path(bin_dir) / "calls"
        run = f'exec {shlex.quote(sys.executable)} "$@"\n'
        if record:
            rec = shlex.quote(str(calls))
            run = (f"printf '%s\\n' \"$*\" >> {rec}\n"
                   f'if [ "$(wc -l < {rec})" -gt 1 ]; then exit 0; fi\n' + run)
        py = Path(bin_dir) / "python3"
        py.write_text("#!/bin/sh\n" + run)
        py.chmod(0o755)
        yield dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}"), calls


def auto_limits_phase():
    """Phase 9: 'auto' past the kernels' knn limit takes the plain route on
    the card, decided before any launch; a named kernel raises."""
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
    from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig, propagate_labels_batched

    emb, seeds = seq_inputs(4, 100, 50, 128, 6, 300)
    cfg = LabelPropConfig(cxt_size=100, radius=10, temperature=0.1, knn=300)
    reset_launches()
    soft, pred = propagate_labels_batched(emb, seeds, cfg)
    torch.cuda.synchronize()
    launched = dict(labelprop_cuda.launches)
    want, want_pred = propagate_labels_batched(emb.cpu(), seeds.cpu(), cfg, device="cpu")
    err = (soft.cpu() - want).abs().max().item()
    same = torch.equal(pred.cpu(), want_pred)
    refused = []
    for kernel in ("cuda_seq", "cuda"):
        try:
            propagate_labels_batched(emb, seeds, cfg, kernel=kernel)
        except ValueError as e:
            refused.append(f"{kernel}: {e}")
    phase("auto_limits", f"knn=300 B=4 T=100 N=50: auto on {soft.device}, launches {launched}, "
          f"maps equal to the CPU plain route={same}, max |soft diff|={err:.3e}; named kernels "
          f"refused: {refused}")
    if (soft.device.type != "cuda" or any(launched.values()) or not same or err > STEP_ATOL
            or len(refused) != 2):
        raise SystemExit("auto past the kernels' limits did not take the plain route alone")
    return launched


def survey_launches(run):
    """Launches of every kernel by survey call while `run()` drives an entry
    point in this process: {kernel: total}, [{kernel: n} per survey call]."""
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda

    per_call = []
    survey = PropagationPipeline.propagate_survey

    def counted(self, *args, **kwargs):
        before = dict(labelprop_cuda.launches)
        result = survey(self, *args, **kwargs)
        per_call.append({k: v - before[k] for k, v in labelprop_cuda.launches.items()})
        return result

    PropagationPipeline.propagate_survey = counted
    reset_launches()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run()
        torch.cuda.synchronize()
    finally:
        PropagationPipeline.propagate_survey = survey
    return dict(labelprop_cuda.launches), per_call


def cli_phase():
    """Phase 10: cli.test_all as the user runs it, the default route and
    --kernel torch, then in this process for the launches."""
    from radar_sounder_crw_tpu_torch.cli import test_all

    maps, walls, stdout = {}, {}, {}
    # the default route through the user's launcher, --kernel torch directly
    for tag, extra, cmd in (
            ("auto", [], ["bash", str(LAUNCH / "launch_test.sh")]),
            ("torch", ["--kernel", "torch"],
             [sys.executable, "-m", "radar_sounder_crw_tpu_torch.cli.test_all"])):
        out = OUT / f"cli_{tag}"
        with launcher_env() as (env, _):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [*cmd, *CLI_ARGS, *extra, "--output_folder", str(out)], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=900)
            walls[tag] = time.perf_counter() - t0
        stdout[tag] = proc.stdout
        miou = [ln for ln in proc.stdout.splitlines() if ln.startswith("mIoU:")]
        # its own clock, from main's start: inference, then with the report
        elapsed = [ln.rsplit(":", 1)[1].strip() for ln in proc.stdout.splitlines()
                   if ln.startswith("Time elapsed")]
        phase("cli", f"test_all {' '.join(extra) or '(default kernel)'} via "
              f"{Path(cmd[-1]).name}: exit {proc.returncode}, {walls[tag]:.2f} s wall, from main's start {' s / '.join(elapsed)} s "
              f"(inference / + metrics), {miou[0] if miou else 'no mIoU line'}")
        if proc.returncode != 0 or not miou:
            raise SystemExit(f"cli.test_all {extra} failed:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
        maps[tag] = np.load(out / "predicted_map.npy")
        for f in ("predicted_map.npy", "predicted_map.pt"):  # 41 MB each: not brought back
            (out / f).unlink()
    agree = float((maps["auto"] == maps["torch"]).mean())
    phase("cli", f"predicted maps {maps['auto'].shape} {maps['auto'].dtype}: default vs "
          f"--kernel torch agreement={agree:.5f}")
    if maps["auto"].shape != maps["torch"].shape or agree < MAP_AGREEMENT:
        raise SystemExit("cli.test_all: the default route disagrees with --kernel torch")

    out = OUT / "cli_launches"
    args = test_all.get_args_parser().parse_args([*CLI_ARGS, "--output_folder", str(out)])
    launched, per_call = survey_launches(lambda: test_all.main(args))
    for f in ("predicted_map.npy", "predicted_map.pt"):
        (out / f).unlink()
    per_pass = [c["prop_seq"] for c in per_call]
    buckets = sum(ln.startswith("Correction batch") for ln in stdout["auto"].splitlines())
    phase("cli", f"launch_test.sh's arguments in process: launches {launched}, prop_seq per "
          f"survey call {per_pass} (forward, {len(per_call) - 2} correction buckets, reverse; "
          f"the launcher's run printed {buckets} buckets)")
    if (len(per_call) != 2 + buckets or per_pass != [1] * len(per_call)
            or launched["prop_seq"] != len(per_call) or launched["prop_step"]
            or launched["prop_all"]):
        raise SystemExit("cli.test_all did not launch prop_seq once per survey call")
    return launched, {"cli_test_all_s": walls["auto"], "cli_test_all_torch_s": walls["torch"],
                      "cli_map_agreement": agree}


def annotate_phase():
    """Phase 11: the annotation server over stdin, then the same session in
    this process for its launches."""
    from radar_sounder_crw_tpu_torch.cli import annotate
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda

    cmds = [{"cmd": "load", "window": 0}, {"cmd": "seed", "seg": "gt"},
            {"cmd": "reseed", "frame": 40, "seg": "gt"}, {"cmd": "metrics"}, {"cmd": "info"},
            {"cmd": "quit"}]
    base = ["--dataset", "3", "--allow_untrained"]
    proc = subprocess.run(
        [sys.executable, "-m", "radar_sounder_crw_tpu_torch.cli.annotate", *base],
        input="".join(json.dumps(c) + "\n" for c in cmds), cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    replies = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    ok = proc.returncode == 0 and len(replies) == 1 + len(cmds) and all(r["ok"] for r in replies)
    phase("annotate", f"exit {proc.returncode}, replies ok {[r.get('ok') for r in replies]}; "
          + "; ".join(json.dumps(r) for r in replies[1:]))
    if not ok:
        raise SystemExit(f"cli.annotate session failed:\n{proc.stdout[-2000:]}\n"
                         f"{proc.stderr[-4000:]}")
    ms = {"annotate_seed_ms": replies[2]["ms"], "annotate_reseed_ms": replies[3]["ms"]}

    session = annotate.AnnotationSession(annotate.get_args_parser().parse_args(base))
    session.handle(json.dumps(cmds[0]))
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        replies = [session.handle(json.dumps(c)) for c in cmds[1:3]]
    torch.cuda.synchronize()
    launched = dict(labelprop_cuda.launches)
    phase("annotate", f"in process: seed {replies[0]['ms']} ms, reseed {replies[1]['ms']} ms, "
          f"launches {launched} (expected prop_seq 2: the seed, then the reseed)")
    if (not all(r["ok"] for r in replies) or launched["prop_seq"] != 2
            or launched["prop_step"] or launched["prop_all"]):
        raise SystemExit("cli.annotate did not launch prop_seq once per seed and reseed")
    return launched, ms


ROUTE_SHAPES = [(T, N) for T in (2, 16, 57, 112) for N in (50, 113, 190)]


def route_b1_phase(smi):
    """Phase 11b: one radargram's propagation through kernel='auto' against
    kernel='cuda' at each (T, N) of ROUTE_SHAPES; returns the table's rows."""
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
    from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig, propagate_labels

    cfg = LabelPropConfig(cxt_size=100, radius=10, temperature=0.1, knn=20)
    want = {"auto": lambda T: {"prop_seq": 1}, "cuda": lambda T: {"prop_step": T - 1}}
    rows = []
    for i, (T, N) in enumerate(ROUTE_SHAPES):
        emb, seeds = seq_inputs(1, T, N, 128, 6, 100 + i)
        row, soft = {"T": T, "N": N}, {}
        for kernel in ("auto", "cuda"):
            call = functools.partial(propagate_labels, emb[0], seeds[0], cfg, kernel=kernel)
            reset_launches()
            soft[kernel] = call()[0]
            torch.cuda.synchronize()
            launched = {k: v for k, v in labelprop_cuda.launches.items() if v}
            if launched != want[kernel](T):
                raise SystemExit(f"route_b1 T={T} N={N}: kernel={kernel!r} launched {launched}")
            row[f"{kernel}_event_ms"] = cuda_ms(call, iters=20, warmup=3)
            row[f"{kernel}_wall_ms"] = wall_ms(call, reps=20)
        if not torch.equal(soft["auto"], soft["cuda"]):
            raise SystemExit(f"route_b1 T={T} N={N}: the two routes' soft labels differ")
        row["wall_ratio"] = row["cuda_wall_ms"] / row["auto_wall_ms"]
        phase("route_b1", f"{smi} | T={T} N={N}: auto (prop_seq) events "
              f"{row['auto_event_ms']:.4f} ms wall {row['auto_wall_ms']:.4f} ms; cuda "
              f"(prop_step x {T - 1}) events {row['cuda_event_ms']:.4f} ms wall "
              f"{row['cuda_wall_ms']:.4f} ms; cuda / auto wall {row['wall_ratio']:.3f}")
        rows.append(row)
    slower = [(r["T"], r["N"]) for r in rows if r["wall_ratio"] < 1]
    phase("route_b1", f"shapes where kernel='cuda' is faster in wall time: {slower or 'none'}")
    OUT.mkdir(exist_ok=True)
    (OUT / "route_b1.json").write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    return rows


PEAK_BF16_FLOPS = 989e12  # H100 SXM bfloat16 tensor cores, dense
TRAIN_STEP1_RTOL = 5e-5  # tests/test_torch_train.py: one ResNet step, two-pass variance
TRAIN_EARLY, TRAIN_ENVELOPE = 5e-6, 2e-4  # tests/test_torch_train.py: CNN K-step losses
ONEPASS_STEP1_RTOL = 5e-4  # tests/test_torch_train.py: one ResNet step, one-pass variance
TRAIN_ARGS = ["--dataset", "3", "--model", "1", "--no_plots"]
UNET_EPOCHS = 5


def step_times(step, iters):
    """Median device ms per call (CUDA events around each call) and host
    wall ms per call over the same `iters` calls."""
    pairs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    return statistics.median(s.elapsed_time(e) for s, e in pairs), wall


def cudnn_benchmark_times(step, iters):
    """`step_times` of `step` with cuDNN choosing its convolution algorithms
    by timing them (torch.backends.cudnn.benchmark) instead of by its
    heuristics, after three calls for the search; the peak memory beside.
    The port's default stays the heuristics: this is a measurement only."""
    torch.backends.cudnn.benchmark = True
    try:
        for _ in range(3):
            step()
        torch.cuda.reset_peak_memory_stats()
        ms, wall = step_times(step, iters)
        return ms, wall, torch.cuda.max_memory_allocated() / 1e9
    finally:
        torch.backends.cudnn.benchmark = False


def step_flops(step):
    """Matmul and convolution operations of one call, forward and backward
    (torch.utils.flop_counter; elementwise work is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step()
    return counter.get_total_flops()


def train_vs_cpu_phase():
    """Phase 12: the CRW trainer on the card against the same trainer on the
    CPU, float32 with TF32 off, one init, one batch schedule: one ResNet-10
    step (the loss and every running mean), then the CNN's 12-step
    trajectory, as tests/test_torch_train.py holds the trainer to JAX's."""
    from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer

    B, T, N, hw = 2, 5, 6, (16, 16)
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((B, T, N, *hw)).astype(np.float32) * 0.5 for _ in range(12)]

    def both(model, fused_bn, K):
        cfg = CRWTrainConfig(model=model, batch_size=B, seq_length=T, lr=1e-3, tau=0.05,
                             fused_bn=fused_bn)
        sides = {dev: CRWTrainer(cfg, device=dev) for dev in ("cuda", "cpu")}
        for tr in sides.values():
            tr.init_state((T, N, *hw))
        sides["cuda"].model.load_state_dict(sides["cpu"].model.state_dict(), strict=True)
        losses = {dev: [float(tr.train_step(batches[0]))] for dev, tr in sides.items()}
        got, want = (sides[d].model.state_dict() for d in ("cuda", "cpu"))
        mean_err = max(  # 1.0 = at the tolerance, rtol 1e-3 + atol 1e-3 x max|mean|
            ((got[n].cpu() - want[n]).abs()
             / (1e-3 * want[n].abs() + 1e-3 * want[n].abs().max())).max().item()
            for n in want if n.endswith("running_mean")) if model == 1 else 0.0
        for b in batches[1:K]:
            for dev, tr in sides.items():
                losses[dev].append(float(tr.train_step(b)))
        rel = np.abs(np.subtract(losses["cuda"], losses["cpu"])) / np.abs(losses["cpu"])
        return losses, rel, mean_err

    result = {}
    for fused_bn, step1_rtol in (("twopass", TRAIN_STEP1_RTOL), (None, ONEPASS_STEP1_RTOL)):
        tag = fused_bn or "onepass"
        losses, rel, mean_err = both(1, fused_bn, 6)
        phase("train_vs_cpu", f"ResNet-10 {tag} B={B} T={T} N={N}: step-1 loss "
              f"{losses['cuda'][0]:.7f} vs {losses['cpu'][0]:.7f} (rel {rel[0]:.2e}, limit "
              f"{step1_rtol:.0e}); running means after step 1 at {mean_err:.3f} of rtol 1e-3; "
              f"steps 2-6 rel {np.array2string(rel[1:], precision=2)} (not held: the ResNet's "
              "trajectory separates as fast between JAX and the port on the CPU)")
        if not (rel[0] <= step1_rtol and mean_err <= 1.0 and np.isfinite(losses["cuda"]).all()):
            raise SystemExit(f"the card's ResNet step disagrees with the CPU's ({tag})")
        result[f"train_vs_cpu_resnet_{tag}_step1_rel"] = float(rel[0])
        result[f"train_vs_cpu_resnet_{tag}_steps_rel"] = rel.tolist()
    losses, rel, _ = both(0, None, 12)
    phase("train_vs_cpu", f"CNN B={B} T={T} N={N} K=12: rel {np.array2string(rel, precision=2)} "
          f"(limits {TRAIN_EARLY:.0e} for the first 4, {TRAIN_ENVELOPE:.0e} throughout)")
    if not (rel[:4].max() <= TRAIN_EARLY and rel.max() <= TRAIN_ENVELOPE):
        raise SystemExit("the card's CNN trajectory leaves the CPU's envelope")
    result["train_vs_cpu_cnn_rel"] = rel.tolist()
    return result


BN_EPS = 1e-5
BENCH = dict(B=8, T=20, patch=(16, 16), overlap=(8, 0))  # bench.py:139
BN_KERNELS = ("bn_stats", "bn_apply", "bn_backward_reduce", "bn_dx")
# bytes a kernel moves per activation element of `size` bytes (each input
# read once, each output written once): stats reads x; apply reads x,
# writes y; the backward reduce reads g and x; dx reads g and x, writes dx
BN_BYTES = {"bn_stats": 1, "bn_apply": 2, "bn_backward_reduce": 2, "bn_dx": 3}
BN_OPS = {"bn_stats": 3, "bn_apply": 4, "bn_backward_reduce": 5, "bn_dx": 5}  # float32 ops
K_DISPATCH = 8  # bench.py:227's K
L2_BYTES = 50e6  # H100 SXM L2
GRAPH_CALLS = 10  # calls captured in one CUDA graph for a device-only time


def graph_ms(fn, copies, calls=GRAPH_CALLS, replays=3):
    """Device-only ms a call: `calls` calls fn(i) captured in one CUDA graph
    and its replays timed with CUDA events, so the host's work around a
    launch (the wrapper's checks, allocations, the ctypes call) is left out.
    Call i reads copy i % copies of its inputs, enough copies that no call
    finds its input in the L2 cache."""
    for i in range(2):
        fn(i % copies)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % copies)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bench_batch():
    """The bench configuration's batch gathered on the card: (seq (B, T, N,
    16, 16), N)."""
    from radar_sounder_crw_tpu_torch.data import RGWindows, gather_windows, synthetic_radargram

    rg, _ = synthetic_radargram(H=912, W=4096, nclasses=5, seed=13)
    ds = RGWindows(rg, length=BENCH["T"], dim=BENCH["patch"], overlap=BENCH["overlap"])
    seq = gather_windows(torch.as_tensor(rg, device="cuda"), np.arange(BENCH["B"]),
                         ds.geo).contiguous()
    return seq, seq.shape[2]


def bench_trainer(dtype, fused_bn=None, k=1):
    from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer

    trainer = CRWTrainer(CRWTrainConfig(
        model=1, patch_size=BENCH["patch"], seq_length=BENCH["T"], overlap=BENCH["overlap"],
        batch_size=BENCH["B"], lr=1e-3, tau=0.01, dtype=dtype, fused_bn=fused_bn,
        steps_per_dispatch=k), device="cuda")
    return trainer


def bn_shapes(patches):
    """(N, C, H, W) of the 13 BatchNorm inputs of the ResNet-10 encoder on
    `patches` 16x16 patches, read by forward hooks."""
    from radar_sounder_crw_tpu_torch.models import BatchNorm, create_model

    model = create_model(1, False, device="cuda")
    shapes = []
    hooks = [m.register_forward_hook(lambda m, inp, out: shapes.append(tuple(inp[0].shape)))
             for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(torch.zeros((2, 1, *BENCH["patch"]), device="cuda"))
    for h in hooks:
        h.remove()
    return [(patches, *s[1:]) for s in shapes]


def ulps(got, want):
    """max |got - want| in units in the last place of `want` in its dtype."""
    bits = 23 if want.dtype == torch.float32 else 7
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), (e - 1 - bits).float())
    return ((got.float() - want.float()).abs() / ulp).max().item()


def bn_kernels_phase(smi, patches):
    """Phase 12b: the four BatchNorm kernels of csrc/bn_train.cu at the 13
    BatchNorm shapes of the bench configuration's step, float32 and
    bfloat16: each against its plain twin on the same inputs (sums bit for
    bit on 2**-5-grid inputs cut to N*H*W <= 16384, within relative 1e-5 of
    the sums of magnitudes on real ones; mean and var bit for bit; y and dx
    within 2 ulp of their dtype given the same sums), then device times
    (CUDA events) of each kernel, its twin and one PyTorch call of the same
    function (torch.var_mean; F.batch_norm with the batch's statistics;
    native_batch_norm_backward for the parameter gradients, and for the
    input gradient, which it computes with its reductions), and
    F.batch_norm(training=True) forward and backward, against the bound.
    Each kernel and library call also has a device-only time (`graph_ms`:
    ten calls in one CUDA graph, each on another copy of its inputs, so
    that neither the host nor the L2 cache sets it), beside PyTorch's own
    sum of all of x and copy of x (the pace the memory gives a read and a
    read-and-write of those bytes), and the tiled kernels repeat their bits
    on a second call. Fails if `bn_backward_reduce`, device-only, is slower
    than native_batch_norm_backward's parameter gradients at any shape."""
    import torch.nn.functional as F

    from radar_sounder_crw_tpu_torch.ops import bn_cuda

    shapes = bn_shapes(patches)
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows, totals, errs = [], {}, {k: 0.0 for k in BN_KERNELS}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        size = torch.finfo(dtype).bits // 8
        tot = totals.setdefault(tag, {})
        for shape in shapes:
            N, C, H, W = shape
            x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
            g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            scale = torch.linspace(0.5, 1.5, C, device="cuda")
            bias = torch.linspace(-0.3, 0.3, C, device="cuda")
            # exact sums on the grid; the backward's with mean 0, var 1 and
            # eps 0 (xhat = x)
            ne = max(1, min(N, 16384 // (H * W)))
            xe, ge = ((torch.randint(-32, 33, (ne, C, H, W), device="cuda", generator=gen) / 32
                       ).to(dtype) for _ in range(2))
            unit = torch.cat([torch.zeros(C, device="cuda"),
                              torch.full((C + 1,), float(ne * H * W), device="cuda")])
            exact = (torch.equal(bn_cuda.stats(xe), bn_cuda.stats_reference(xe))
                     and torch.equal(bn_cuda.backward_reduce(ge, xe, unit, 0.0),
                                     bn_cuda.backward_reduce_reference(ge, xe, unit, 0.0)))
            # real inputs
            xf, gf = x.float(), g.float()
            sums, sums_t = bn_cuda.stats(x), bn_cuda.stats_reference(x)
            mags = torch.cat([xf.abs().sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                              sums_t[-1:]])
            y, mean, var = bn_cuda.apply(x, sums, scale, bias, BN_EPS)
            y_t, mean_t, var_t = bn_cuda.apply_reference(x, sums, scale, bias, BN_EPS)
            gsums = bn_cuda.backward_reduce(g, x, sums, BN_EPS)
            gsums_t = bn_cuda.backward_reduce_reference(g, x, sums, BN_EPS)
            _, _, inv = bn_cuda._moments_reference(sums, C, BN_EPS)
            xhat = (xf - mean_t.view(1, C, 1, 1)) * inv
            gmags = torch.cat([gf.abs().sum((0, 2, 3)), (gf * xhat).abs().sum((0, 2, 3))])
            dx = bn_cuda.dx(g, x, sums, gsums, scale, BN_EPS)
            dx_t = bn_cuda.dx_reference(g, x, sums, gsums, scale, BN_EPS)
            again = bn_cuda.apply(x, sums, scale, bias, BN_EPS)
            check = {
                "repeat_equal": (torch.equal(bn_cuda.stats(x), sums)
                                 and all(torch.equal(a, b) for a, b in zip(again, (y, mean, var)))
                                 and torch.equal(bn_cuda.backward_reduce(g, x, sums, BN_EPS),
                                                 gsums)),
                "sums_rel": ((sums - sums_t).abs() / mags).max().item(),
                "gsums_rel": ((gsums - gsums_t).abs() / gmags).max().item(),
                "y_ulps": ulps(y, y_t), "dx_ulps": ulps(dx, dx_t),
                "mean_var_equal": torch.equal(mean, mean_t) and torch.equal(var, var_t),
                "grid_sums_equal": exact,
            }
            for k, d in (("bn_stats", sums - sums_t), ("bn_apply", y.float() - y_t.float()),
                         ("bn_backward_reduce", gsums - gsums_t),
                         ("bn_dx", dx.float() - dx_t.float())):
                errs[k] = max(errs[k], d.abs().max().item())
            if not (exact and check["repeat_equal"] and check["mean_var_equal"]
                    and check["sums_rel"] <= 1e-5
                    and check["gsums_rel"] <= 1e-5 and check["y_ulps"] <= 2
                    and check["dx_ulps"] <= 2):
                raise SystemExit(f"a BatchNorm kernel disagrees with its twin at {shape} "
                                 f"{tag}: {check}")
            # times: the kernels, their twins, one PyTorch call of the same function
            mean_, invstd = mean.clone(), torch.rsqrt(var + BN_EPS)
            calls = {  # name: (kernel, plain twin, library call or None)
                "bn_stats": (lambda: bn_cuda.stats(x), lambda: bn_cuda.stats_reference(x),
                             lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0)),
                "bn_apply": (lambda: bn_cuda.apply(x, sums, scale, bias, BN_EPS),
                             lambda: bn_cuda.apply_reference(x, sums, scale, bias, BN_EPS),
                             lambda: F.batch_norm(x, mean, var, scale, bias, False, 0.0, BN_EPS)),
                "bn_backward_reduce": (
                    lambda: bn_cuda.backward_reduce(g, x, sums, BN_EPS),
                    lambda: bn_cuda.backward_reduce_reference(g, x, sums, BN_EPS),
                    lambda: torch.ops.aten.native_batch_norm_backward(
                        g, x, scale, None, None, mean_, invstd, True, BN_EPS,
                        [False, True, True])),
                "bn_dx": (lambda: bn_cuda.dx(g, x, sums, gsums, scale, BN_EPS),
                          lambda: bn_cuda.dx_reference(g, x, sums, gsums, scale, BN_EPS),
                          lambda: torch.ops.aten.native_batch_norm_backward(
                              g, x, scale, None, None, mean_, invstd, True, BN_EPS,
                              [True, False, False])),
            }
            ms = {k: cuda_ms(c[0], 10, 2) for k, c in calls.items()}
            plain = {k: cuda_ms(c[1], 5, 1) for k, c in calls.items()}
            library = {k: cuda_ms(c[2], 10, 2) for k, c in calls.items()}
            # device-only: the same calls on copies of x and g, in a graph
            copies = min(GRAPH_CALLS, max(1, int(-(-2 * L2_BYTES // (x.numel() * size)))))
            xs = [x] + [x.clone() for _ in range(copies - 1)]
            gs = [g] + [g.clone() for _ in range(copies - 1)]
            on_copy = {  # name: (kernel, library call) of copy i
                "bn_stats": (lambda i: bn_cuda.stats(xs[i]),
                             lambda i: torch.var_mean(xs[i], dim=(0, 2, 3), correction=0)),
                "bn_apply": (lambda i: bn_cuda.apply(xs[i], sums, scale, bias, BN_EPS),
                             lambda i: F.batch_norm(xs[i], mean, var, scale, bias, False, 0.0,
                                                    BN_EPS)),
                "bn_backward_reduce": (
                    lambda i: bn_cuda.backward_reduce(gs[i], xs[i], sums, BN_EPS),
                    lambda i: torch.ops.aten.native_batch_norm_backward(
                        gs[i], xs[i], scale, None, None, mean_, invstd, True, BN_EPS,
                        [False, True, True])),
                "bn_dx": (lambda i: bn_cuda.dx(gs[i], xs[i], sums, gsums, scale, BN_EPS),
                          lambda i: torch.ops.aten.native_batch_norm_backward(
                              gs[i], xs[i], scale, None, None, mean_, invstd, True, BN_EPS,
                              [True, False, False])),
            }
            device = {k: graph_ms(c[0], copies) for k, c in on_copy.items()}
            device_library = {k: graph_ms(c[1], copies) for k, c in on_copy.items()}
            # what PyTorch's own kernels take to read x (one sum of all of
            # it) and to copy it: the memory's practical pace for stats and
            # apply
            read = graph_ms(lambda i: xs[i].sum(), copies)
            copy = graph_ms(lambda i: torch.empty_like(xs[i]).copy_(xs[i]), copies)
            del xs, gs, on_copy
            rm, rv = torch.zeros(C, device="cuda"), torch.ones(C, device="cuda")
            xr = x.detach().requires_grad_(True)
            w, b = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
            lib_fwd = cuda_ms(lambda: F.batch_norm(x, rm, rv, scale, bias, True, 0.1, BN_EPS),
                              10, 2)
            lib_both = cuda_ms(lambda: torch.autograd.grad(
                F.batch_norm(xr, rm, rv, w, b, True, 0.1, BN_EPS), (xr, w, b), g), 10, 2)
            elems = N * C * H * W
            bound = {k: max(BN_BYTES[k] * size * elems / PEAK_BYTES,
                            BN_OPS[k] * elems / PEAK_F32_FLOPS) * 1e3 for k in BN_KERNELS}
            row = {"shape": list(shape), "dtype": tag, **check, "ms": ms, "bound_ms": bound,
                   "plain_ms": plain, "library_ms": library, "device_ms": device,
                   "device_library_ms": device_library, "device_read_ms": read,
                   "device_copy_ms": copy,
                   "device_share": {k: bound[k] / device[k] for k in BN_KERNELS},
                   "fwd_ms": ms["bn_stats"] + ms["bn_apply"],
                   "bwd_ms": ms["bn_backward_reduce"] + ms["bn_dx"],
                   "plain_fwd_ms": plain["bn_stats"] + plain["bn_apply"],
                   "plain_bwd_ms": plain["bn_backward_reduce"] + plain["bn_dx"],
                   "batch_norm_fwd_ms": lib_fwd, "batch_norm_bwd_ms": lib_both - lib_fwd}
            rows.append(row)
            for k in BN_KERNELS:
                for key, v in (("ms", ms), ("bound_ms", bound), ("plain_ms", plain),
                               ("library_ms", library), ("device_ms", device),
                               ("device_library_ms", device_library)):
                    tot[f"{k}_{key}"] = tot.get(f"{k}_{key}", 0.0) + v[k]
            for k in ("fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_bwd_ms", "batch_norm_fwd_ms",
                      "batch_norm_bwd_ms", "device_read_ms", "device_copy_ms"):
                tot[k] = tot.get(k, 0.0) + row[k]
            del x, g, xf, gf, xhat, xr, y, y_t, dx, dx_t, calls, again, xe, ge
        tot["bound_ms"] = sum(tot[f"{k}_bound_ms"] for k in BN_KERNELS)
        for k in BN_KERNELS:
            tot[f"{k}_device_share"] = tot[f"{k}_bound_ms"] / tot[f"{k}_device_ms"]
        phase("bn_kernels", f"{tag}, 13 shapes of {patches} patches: kernels fwd "
              f"{tot['fwd_ms']:.3f} + bwd {tot['bwd_ms']:.3f} ms a step (stats "
              f"{tot['bn_stats_ms']:.3f}, apply {tot['bn_apply_ms']:.3f}, reduce "
              f"{tot['bn_backward_reduce_ms']:.3f}, dx {tot['bn_dx_ms']:.3f}); bound "
              f"{tot['bound_ms']:.3f}; plain twin {tot['plain_fwd_ms']:.3f} + "
              f"{tot['plain_bwd_ms']:.3f}; F.batch_norm {tot['batch_norm_fwd_ms']:.3f} + "
              f"{tot['batch_norm_bwd_ms']:.3f}; one PyTorch call a kernel "
              + " ".join(f"{k[3:]}={tot[k + '_library_ms']:.3f}" for k in BN_KERNELS))
        phase("bn_kernels", f"{tag}, device-only (graphs of {GRAPH_CALLS} calls, cold L2): "
              + " ".join(f"{k[3:]} {tot[k + '_device_ms']:.4f} ms (bound "
                         f"{tot[k + '_bound_ms']:.4f}, share {tot[k + '_device_share']:.3f}; "
                         f"library {tot[k + '_device_library_ms']:.4f})" for k in BN_KERNELS)
              + f"; torch.sum of x {tot['device_read_ms']:.4f}, a copy of x "
              f"{tot['device_copy_ms']:.4f}")
        torch.cuda.empty_cache()
    for r in rows:
        phase("bn_kernels", f"{r['dtype']} {tuple(r['shape'])}: kernels "
              + " ".join(f"{k[3:]}={r['ms'][k]:.4f}" for k in BN_KERNELS)
              + f" (bound {sum(r['bound_ms'].values()):.4f}); twin {r['plain_fwd_ms']:.3f}+"
              f"{r['plain_bwd_ms']:.3f}; F.batch_norm {r['batch_norm_fwd_ms']:.4f}+"
              f"{r['batch_norm_bwd_ms']:.4f}; sums rel {r['sums_rel']:.1e}/{r['gsums_rel']:.1e}, "
              f"ulps y {r['y_ulps']:.0f} dx {r['dx_ulps']:.0f}; device-only "
              + " ".join(f"{k[3:]}={r['device_ms'][k]:.4f} ({r['device_share'][k]:.2f}, library "
                         f"{r['device_library_ms'][k]:.4f})" for k in BN_KERNELS)
              + f", sum {r['device_read_ms']:.4f}, copy {r['device_copy_ms']:.4f}")
    phase("times", f"{smi} | " + " ".join(
        f"bn_{tag}_{k}={v:.4f}" for tag, t in totals.items() for k, v in t.items()))
    OUT.mkdir(exist_ok=True)
    with open(OUT / "bn_kernels.json", "w") as f:
        json.dump({"card": smi, "rows": rows, "totals": totals}, f)
    # the backward reduce, device-only, against PyTorch's parameter
    # gradients (native_batch_norm_backward) at every shape and dtype
    k = "bn_backward_reduce"
    slower = [(r["dtype"], tuple(r["shape"]), r["device_ms"][k], r["device_library_ms"][k])
              for r in rows if r["device_ms"][k] > r["device_library_ms"][k]]
    if slower:
        raise SystemExit(f"bn_backward_reduce is slower than native_batch_norm_backward's "
                         f"parameter gradients (dtype, shape, ms, library ms): {slower}")
    return {"rows": rows, "totals": totals, "max_abs_err": errs}


def require_freed(what, *refs):
    """Called right after `del` of the referents of `refs` (trainers) with
    the cyclic collector off: turns it back on, and fails unless every one
    was freed by reference counting alone, so that no reference cycle holds
    a trainer, its CUDA graph or the graph's memory pool."""
    alive = sum(r() is not None for r in refs)
    gc.enable()
    if alive:
        raise SystemExit(f"{what}: {alive} dropped trainer(s) not freed with the cyclic "
                         f"collector off (a reference cycle holds them)")


def crw_step_phase(smi):
    """Phase 13: CRW train steps at bench.py's configuration (B 8, T 20,
    16x16 patches, overlap (8, 0), synthetic SHARAD 912 x 4096 seed 13,
    N = 113; ResNet-10, lr 1e-3, tau 0.01), the batch gathered once on the
    card, float32 and bfloat16, with each BatchNorm (fused_bn None, 'fused',
    'lean') and with steps_per_dispatch 1 and 8 (one CUDA graph replay of
    eight steps; float32 at k = 8 with flax's BatchNorm alone)."""
    from radar_sounder_crw_tpu_torch.ops import bn_cuda
    from radar_sounder_crw_tpu_torch.ops.crw import crw_loss
    from radar_sounder_crw_tpu_torch.train import step_graph

    seq, N = bench_batch()
    B, T = BENCH["B"], BENCH["T"]
    seqs = seq.expand(K_DISPATCH, *seq.shape)
    emb = torch.randn((B, T, N, 128), device="cuda", requires_grad=True)

    def loss_step():
        per, _ = crw_loss(emb, 0.01, per_item=True)
        per.mean().backward()

    loss_flops = step_flops(loss_step)
    times, bn_launches = {}, {}
    configs = [(dtag, dtype, peak, fb, k)
               for dtag, dtype, peak in (("f32", torch.float32, PEAK_F32_FLOPS),
                                         ("bf16", torch.bfloat16, PEAK_BF16_FLOPS))
               for fb in (None, "fused", "lean") for k in (1, K_DISPATCH)
               if not (dtag == "f32" and k > 1 and fb is not None)]
    for dtag, dtype, peak, fused_bn, k in configs:
        tag = f"{dtag}" + (f"_{fused_bn}" if fused_bn else "") + (f"_k{k}" if k > 1 else "")
        trainer = bench_trainer(dtype, fused_bn, k)
        trainer.init_state(tuple(seq.shape[1:]))
        if k == 1:  # float32: 10 timed steps with flax's BatchNorm, 5 with the others
            run, per_call = (lambda: trainer.train_step(seq)), 1
            iters = 20 if dtag == "bf16" else 10 if fused_bn is None else 5
            losses = [float(run()) for _ in range(3)]  # warm-up
        else:
            run, per_call = (lambda: trainer.train_chunk(seqs)), k
            iters = 1 if dtag == "f32" else 3
            losses = [float(v) for _ in range(2) for v in run()]  # eager + capture, a replay
        replays = step_graph.replays
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        ms, wall = step_times(run, iters)
        launched = dict(bn_cuda.launches)
        replayed = step_graph.replays - replays
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        profiled, out = (3 if k == 1 and dtag == "bf16" else 1), []  # calls under the profiler
        busy = device_busy(lambda: [out.append(run()) for _ in range(profiled)],
                           warm=profiled == 3)
        loss = float(out[-1][-1] if k > 1 else out[-1])
        if not (np.isfinite(losses).all() and np.isfinite(loss)):
            raise SystemExit(f"CRW training at the bench configuration gave a non-finite loss "
                             f"({tag})")
        want = {"bn_stats": 0, "bn_apply": 0, "bn_backward_reduce": 0, "bn_dx": 0}
        if k == 1 and fused_bn == "fused":
            want = {name: 13 * iters for name in want}
        elif k == 1 and fused_bn == "lean":
            want["bn_stats"] = 13 * iters
        if launched != want or replayed != (iters if k > 1 else 0):
            raise SystemExit(f"crw_step {tag}: launches {launched} (expected {want}), graph "
                             f"replays {replayed}")
        if k == 1 and fused_bn:
            bn_launches[f"{dtag}_{fused_bn}"] = launched
        m = {"ms": ms / per_call, "wall_ms": wall / per_call, "steps_per_s": 1e3 * per_call / wall,
             "peak_gb": peak_gb, "reserved_gb": reserved_gb,
             "device_idle_share": busy["device_idle_share"]}
        extra = ""
        if k == 1 and fused_bn is None:  # the default step's operations and cuDNN search
            flops = step_flops(run)
            bound_ms = ((flops - loss_flops) / peak + loss_flops / PEAK_F32_FLOPS) * 1e3
            bench_ms, bench_wall, bench_gb = cudnn_benchmark_times(run, 5)
            m.update({"gflop": flops / 1e9, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                      "cudnn_benchmark_ms": bench_ms, "cudnn_benchmark_wall_ms": bench_wall,
                      "cudnn_benchmark_peak_gb": bench_gb})
            extra = (f", {flops / 1e9:.1f} GFLOP (loss {loss_flops / 1e9:.2f}), bound "
                     f"{bound_ms:.3f} ms (share {bound_ms / ms:.3f}); with cudnn.benchmark "
                     f"{bench_ms:.3f} ms ({bench_wall:.3f} wall, peak {bench_gb:.2f} GB)")
        times.update({f"crw_step_{tag}_{key}": v for key, v in m.items()})
        phase("crw_step", f"{tag} B={B} T={T} N={N}: {m['ms']:.3f} ms a step (events, median "
              f"of {iters} calls of {per_call} steps), {m['wall_ms']:.3f} ms wall, "
              f"{m['steps_per_s']:.2f} steps/s, peak {peak_gb:.2f} GB (reserved "
              f"{reserved_gb:.2f}), idle {busy['device_idle_share']:.4f}, BatchNorm kernel "
              f"launches {launched}, graph replays {replayed}{extra}; losses {losses[0]:.5f} "
              f"-> {loss:.5f}")
        ref = weakref.ref(trainer)
        gc.disable()
        del trainer, run
        require_freed(f"crw_step {tag}", ref)
        torch.cuda.empty_cache()
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
    times.update(graph_vs_eager(seq))
    return times, bn_launches


def graph_vs_eager(seq):
    """Phase 13b: steps_per_dispatch = 8 at the bench configuration in
    bfloat16 with cuDNN deterministic: two chunks (the first eager, the
    second one graph replay) against sixteen eager steps of the same
    configuration, bit for bit: losses, parameters and buffers, Adam's
    state; flax's BatchNorm and the `fused` kernels."""
    from radar_sounder_crw_tpu_torch.train import step_graph

    seqs = seq.expand(K_DISPATCH, *seq.shape)
    result = {}
    torch.backends.cudnn.deterministic = True
    try:
        for fused_bn in (None, "fused"):
            graphed = bench_trainer(torch.bfloat16, fused_bn, K_DISPATCH)
            eager = bench_trainer(torch.bfloat16, fused_bn, K_DISPATCH)
            for tr in (graphed, eager):
                tr.init_state(tuple(seq.shape[1:]))
            eager.model.load_state_dict(graphed.model.state_dict(), strict=True)
            replays = step_graph.replays
            got = torch.cat([graphed.train_chunk(seqs), graphed.train_chunk(seqs)])
            want = torch.stack([eager.train_step(seq) for _ in range(2 * K_DISPATCH)])
            torch.cuda.synchronize()
            equal = {
                "losses": torch.equal(got, want),
                "state": all(torch.equal(v, eager.model.state_dict()[n])
                             for n, v in graphed.model.state_dict().items()),
                "adam": all(torch.equal(v, eager.optimizer.state_dict()["state"][i][n])
                            for i, st in graphed.optimizer.state_dict()["state"].items()
                            for n, v in st.items()),
                "one_replay": step_graph.replays - replays == 1,
            }
            tag = fused_bn or "flax"
            phase("graph_vs_eager", f"bf16 {tag}: two chunks of {K_DISPATCH} (eager, then one "
                  f"replay) vs {2 * K_DISPATCH} eager steps, cuDNN deterministic: {equal}; "
                  f"losses {got[0].item():.5f} -> {got[-1].item():.5f}")
            if not all(equal.values()):
                raise SystemExit(f"the CUDA graph of {K_DISPATCH} steps differs from eager "
                                 f"steps ({tag})")
            result[f"graph_vs_eager_bf16_{tag}"] = equal
            refs = weakref.ref(graphed), weakref.ref(eager)
            gc.disable()
            del graphed, eager, tr
            require_freed(f"graph_vs_eager {tag}", *refs)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return result


def train_cli_phase():
    """Phases 14-15: the user's training command at its defaults, float32
    (through the launcher launch_train.sh) and --bf16, as processes from the
    shell."""
    walls, pts = {}, {}
    module = [sys.executable, "-m", "radar_sounder_crw_tpu_torch.cli.train"]
    for tag, extra, cmd in (
            ("f32", [], ["bash", str(LAUNCH / "launch_train.sh")]),
            ("bf16", ["--bf16"], module),
            ("bf16_k8", ["--bf16", "--steps_per_dispatch", str(K_DISPATCH)], module)):
        out = OUT / f"train_{tag}"
        with launcher_env() as (env, _):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [*cmd, *TRAIN_ARGS, *extra, "--output_folder", str(out)], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=900)
            walls[tag] = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        epochs = [ln for ln in lines if ln.startswith("Epoch: ")]
        phase("train_cli", f"cli.train {' '.join(TRAIN_ARGS + extra)} via {Path(cmd[-1]).name}: "
              f"exit {proc.returncode}, {walls[tag]:.2f} s wall; " + "; ".join(
                  ln for ln in lines if ln.startswith(("Number of", "Epoch: ", "Finished"))))
        if (proc.returncode != 0 or "Finished training." not in lines or len(epochs) != 2
                or not all(np.isfinite(float(ln.split()[3])) for ln in epochs)):
            raise SystemExit(f"cli.train {extra} failed:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
        walls[f"{tag}_epoch_s"] = [float(ln.rsplit(" ", 1)[1]) for ln in epochs]
        pts[tag] = out / "models" / "sharad16_3.pt"
    return {f"cli_train_{tag}_{key}": walls[f"{tag}{suffix}"] for tag in pts
            for key, suffix in (("s", ""), ("epoch_s", "_epoch_s"))}, pts


LAUNCH_BATCH = {  # launcher: (its arguments, its number of runs)
    "launch_test_batch": (CLI_ARGS, 27),
    "launch_train_batch": (["--dataset", "3", "--model", "1", "--no_plots", "--epochs", "1"], 81),
}


def launch_phase():
    """Phase 15b: the two sweep launchers, each with a `python3` that runs
    the first grid point on the card and records every call."""
    walls, counts = {}, {}
    for name, (args, runs) in LAUNCH_BATCH.items():
        out = OUT / name
        with launcher_env(record=True) as (env, record):
            t0 = time.perf_counter()
            proc = subprocess.run(
                ["bash", str(LAUNCH / f"{name}.sh"), *args, "--output_folder", str(out)],
                cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
            # the first run's, with 26 or 80 recorded calls of a few ms each
            walls[name] = time.perf_counter() - t0
            calls = record.read_text().splitlines() if record.exists() else []
        counts[name] = len(calls)
        lines = proc.stdout.splitlines()
        if name == "launch_test_batch":
            first = "--radius 5 --temp 0.01 --knn 5"
            result = [ln for ln in lines if ln.startswith("mIoU:")]
            ok = bool(result)
            for f in ("predicted_map.npy", "predicted_map.pt"):  # 41 MB each: not brought back
                (out / f).unlink(missing_ok=True)
        else:
            first = "--seq_length 10 --lr 1e-2 --tau 1e-1 --overlap 8 0"
            pt = out / "models" / "crw_s10_lr1e-2_tau1e-1_ov8_0.pt"
            result = [ln for ln in lines if ln.startswith(("Epoch: ", "Finished"))]
            epochs = [ln for ln in result if ln.startswith("Epoch: ")]
            ok = (pt.is_file() and "Finished training." in result and len(epochs) == 1
                  and np.isfinite(float(epochs[0].split()[3])))
            result.append(f"wrote {pt.relative_to(OUT)}: {pt.is_file()}")
            pt.unlink(missing_ok=True)  # 20 MB: not brought back
        phase("launch", f"{name}.sh {' '.join(args)}: exit {proc.returncode}, {counts[name]} "
              f"calls (expected {runs}), the first ({first}) run on the card in "
              f"{walls[name]:.2f} s wall; " + "; ".join(result))
        if (proc.returncode != 0 or counts[name] != runs or not calls
                or f" {first} " not in f" {calls[0]} " or not ok):
            raise SystemExit(f"{name}.sh failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return {**{f"{k}_first_run_s": v for k, v in walls.items()},
            **{f"{k}_calls": v for k, v in counts.items()}}


def trained_inference_phase(pts):
    """Phase 16: each trained encoder file through inference: SHARAD window
    0 seed->map (T = 100, N = 113) on the default route and the plain one."""
    from radar_sounder_crw_tpu_torch.data import create_dataset, get_reference
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
    from radar_sounder_crw_tpu_torch.models import create_model, load_torch_checkpoint
    from radar_sounder_crw_tpu_torch.ops import confusion_matrix, labelprop_cuda, miou
    from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig
    from radar_sounder_crw_tpu_torch.utils import resize_nearest

    T, patch = 100, (16, 16)
    ds = create_dataset(full=True, id=3, length=T, dim=patch, overlap=(8, 0))
    geo = ds.geo
    nclasses, seg = get_reference(id=3, h=geo.nh * patch[0], w=0, length=T, dim=patch)
    seq = torch.as_tensor(ds[0], device="cuda")
    N = seq.shape[1]
    seg_ref = seg[: geo.rg_h(), : geo.w]
    gt = resize_nearest(seg[: geo.rg_h(), : geo.rg_len()], (N, T))
    cfg = LabelPropConfig(cxt_size=100, radius=10, temperature=0.1, knn=20)
    result = {}
    for tag, pt in pts.items():
        model = load_torch_checkpoint(pt, create_model(1, False, device="cuda"))
        pipe = PropagationPipeline(model, cfg, nclasses)
        plain = PropagationPipeline(model, cfg, nclasses, kernel="torch")
        pipe(seq, seg_ref)  # warm-up
        reset_launches()
        res = pipe(seq, seg_ref, detect_change=True)
        torch.cuda.synchronize()
        launched = dict(labelprop_cuda.launches)
        ref = plain(seq, seg_ref, detect_change=True)
        agree = float((res.prediction == ref.prediction).mean())
        mi = miou(confusion_matrix(gt.ravel(), res.prediction.ravel(), nclasses))
        phase("trained_inference", f"{tag} encoder {pt.name} loaded strict: SHARAD window 0 "
              f"T={T} N={N}, default route launches {launched}, vs the plain route map "
              f"agreement={agree:.5f}, change_idx {res.change_idx} vs {ref.change_idx}; mIoU "
              f"vs the synthetic ground truth {mi:.5f}")
        if (agree < MAP_AGREEMENT or res.change_idx != ref.change_idx
                or launched["prop_seq"] != 1 or launched["prop_step"]
                or res.prediction.shape != (N, T)):
            raise SystemExit(f"the {tag} trained encoder's seed->map disagrees across routes")
        result[f"trained_{tag}_map_agreement"] = agree
        result[f"trained_{tag}_miou"] = mi
        pt.unlink()  # 20 MB each: not brought back
    return result


def unet_phase(smi):
    """Phases 17-18: UNet steps at scripts/test_unet.py's width and batch (64
    strips of 912 x 64, 5 classes), then cli.test_unet as the user runs it
    with --epochs 5, float32 and --bf16."""
    from radar_sounder_crw_tpu_torch.data import load_raw_pair
    from radar_sounder_crw_tpu_torch.train import UNetTrainConfig, UNetTrainer, unfold_strips

    rg, sg = load_raw_pair(3)
    x, y = unfold_strips(rg, sg.astype(np.int32), 64, 5)
    bx = torch.as_tensor(x[:64], device="cuda").permute(0, 3, 1, 2).contiguous()
    by = torch.as_tensor(y[:64], device="cuda")
    times = {}
    for tag, dtype, peak in (("f32", torch.float32, PEAK_F32_FLOPS),
                             ("bf16", torch.bfloat16, PEAK_BF16_FLOPS)):
        trainer = UNetTrainer(UNetTrainConfig(dtype=dtype), device="cuda")
        trainer.init_state(x.shape)
        losses = [float(trainer.train_step(bx, by)) for _ in range(2)]  # warm-up
        flops = step_flops(lambda: trainer.train_step(bx, by))
        torch.cuda.reset_peak_memory_stats()
        ms, wall = step_times(lambda: trainer.train_step(bx, by), 5)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy = device_busy(lambda: [trainer.train_step(bx, by) for _ in range(2)])
        bench_ms, bench_wall, bench_gb = cudnn_benchmark_times(
            lambda: trainer.train_step(bx, by), 5)
        bound_ms = flops / peak * 1e3
        if not np.isfinite(losses).all():
            raise SystemExit(f"UNet training gave a non-finite loss ({tag})")
        times.update({
            f"unet_step_{tag}_ms": ms,
            f"unet_step_{tag}_wall_ms": wall,
            f"unet_steps_per_s_{tag}": 1e3 / wall,
            f"unet_step_{tag}_peak_gb": peak_gb,
            f"unet_step_{tag}_gflop": flops / 1e9,
            f"unet_step_{tag}_bound_ms": bound_ms,
            f"unet_step_{tag}_bound_share": bound_ms / ms,
            f"unet_step_{tag}_device_idle_share": busy["device_idle_share"],
            f"unet_step_{tag}_cudnn_benchmark_ms": bench_ms,
            f"unet_step_{tag}_cudnn_benchmark_peak_gb": bench_gb,
        })
        phase("unet_step", f"{tag} B=64 912x64: {ms:.2f} ms a step (events, median of 5), "
              f"{wall:.2f} ms wall, peak {peak_gb:.2f} GB, {flops / 1e12:.2f} TFLOP, bound "
              f"{bound_ms:.2f} ms (share {bound_ms / ms:.3f}), idle "
              f"{busy['device_idle_share']:.4f}; with cudnn.benchmark {bench_ms:.2f} ms (peak "
              f"{bench_gb:.2f} GB); losses {losses}")
        del trainer
        torch.cuda.empty_cache()

    for tag, extra in (("f32", []), ("bf16", ["--bf16"])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "radar_sounder_crw_tpu_torch.cli.test_unet", "--epochs",
             str(UNET_EPOCHS), *extra], cwd=ROOT, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        epoch_s = [float(ln.rsplit(" ", 1)[1]) for ln in lines if ln.startswith("Epoch: ")]
        mi = [ln for ln in lines if ln.startswith("mIoU:")]
        phase("unet_cli", f"cli.test_unet --epochs {UNET_EPOCHS} {' '.join(extra)}: exit "
              f"{proc.returncode}, {wall:.2f} s wall, epochs {epoch_s} s, "
              f"{mi[0] if mi else 'no mIoU line'}")
        if proc.returncode != 0 or not mi or len(epoch_s) != UNET_EPOCHS:
            raise SystemExit(f"cli.test_unet {extra} failed:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
        steps = -(-int(len(x) * 0.9) // 64)  # 115 training strips at batch 64
        ms_step = statistics.median(epoch_s[1:]) / steps * 1e3  # after the first epoch
        times[f"cli_test_unet_{tag}_s"] = wall
        times[f"cli_test_unet_{tag}_ms_per_step"] = ms_step
        times[f"cli_test_unet_{tag}_miou"] = float(mi[0].split()[1])
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
    return times


TUNE_SCALE = "4"  # RSCRW_SYNTH_SCALE: dataset 0's synthetic 410 x 27330 line cut to 410 x 6832
TUNE_CMD = ["-m", "radar_sounder_crw_tpu_torch.cli.train", "--tune", "--tune_samples", "4"]
TUNE_TRIAL_EPOCHS = 7  # 4 samples at max_t 3, grace 1, reduction 2: rungs of 4, 2 and 1


def tune_phase():
    """Phase 19: the ASHA sweep as the user starts it, `cli.train --tune
    --tune_samples 4 --tune_ckpt_dir <dir>` at the tuner's defaults (dataset
    0, ResNet-10 at full width, T = 8, 32x32 patches, the reference grid,
    max_t 3), the synthetic line's length cut by RSCRW_SYNTH_SCALE; then the
    same command again, which must resume with every rung done, train
    nothing (the sweep ledger unchanged, the last rung's line alone, read
    back) and report the same best trial."""
    import shutil

    ckpt = OUT / "tune_sweep"
    shutil.rmtree(ckpt, ignore_errors=True)
    env = {**os.environ, "RSCRW_SYNTH_SCALE": TUNE_SCALE}
    runs, ledgers, walls = {}, {}, {}
    for tag in ("sweep", "resume"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *TUNE_CMD, "--tune_ckpt_dir", str(ckpt)], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=900)
        walls[tag] = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        runs[tag] = {"rungs": [ln for ln in lines if ln.startswith("[asha] trial ")],
                     "best": [ln for ln in lines if ln.startswith("Best trial ")],
                     "resumed": any(ln.startswith("[asha] resuming sweep") for ln in lines)}
        phase("tune", f"{tag}: exit {proc.returncode}, {walls[tag]:.2f} s wall, "
              f"{len(runs[tag]['rungs'])} rung lines; " + "; ".join(runs[tag]["best"]))
        if proc.returncode != 0 or len(runs[tag]["best"]) != 2:
            raise SystemExit(f"cli.train --tune ({tag}) failed:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
        ledgers[tag] = json.loads((ckpt / "sweep.json").read_text())
    sweep, resume = runs["sweep"], runs["resume"]
    epochs = [t["epoch_times"] for t in ledgers["sweep"]["trials"]]
    phase("tune", "epoch s by trial " + "; ".join(
        f"{i}: " + ", ".join(f"{e:.2f}" for e in ts) for i, ts in enumerate(epochs))
        + "; rung lines of the sweep: " + " | ".join(sweep["rungs"]))
    checks = {
        "seven trial-epochs": len(sweep["rungs"]) == TUNE_TRIAL_EPOCHS
        and sum(len(ts) for ts in epochs) == TUNE_TRIAL_EPOCHS,
        "resumed": resume["resumed"],
        "resume trained nothing": ledgers["resume"] == ledgers["sweep"],
        "only the last rung read back": resume["rungs"] == sweep["rungs"][-1:],
        "same best trial": resume["best"] == sweep["best"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    phase("tune", "checks: " + ", ".join(f"{k}={ok}" for k, ok in checks.items()))
    if failed:
        raise SystemExit(f"tune checks failed: {failed}")
    shutil.rmtree(ckpt)  # four trials' checkpoints, ~0.1 GB: not brought back
    return {"tune_sweep_s": walls["sweep"], "tune_resume_s": walls["resume"],
            "tune_epoch_s": epochs}


DP_FLAG = "--data-parallel-rank"


def dp_state_digest(state) -> str:
    """A digest of a state dict's bytes: two ranks hold the same state iff
    their digests agree."""
    import hashlib

    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_rank_main(backend: str) -> int:
    """One rank of the data_parallel phase, started by torch.distributed.run
    (`chip_smoke.py --data-parallel-rank nccl|gloo`): CRW steps at
    bench.py's configuration and the Miguel survey on this rank's mesh and
    on its device alone, and steps_per_dispatch = 2 on the mesh (a graph
    against eager steps over NCCL, refused over gloo); rank 0 prints one
    `DP_RESULT {json}` line, every rank a `DP_DIGEST` line of its trained
    state."""
    import dataclasses

    import torch.distributed as dist

    from radar_sounder_crw_tpu_torch.data import RGWindows, gather_windows, synthetic_radargram
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
    from radar_sounder_crw_tpu_torch.models import create_model
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
    from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig
    from radar_sounder_crw_tpu_torch.parallel import Mesh, init_distributed, make_mesh
    from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer
    from radar_sounder_crw_tpu_torch.utils import parity_mode

    parity_mode()
    if backend == "nccl":
        init_distributed()  # this rank on cuda:LOCAL_RANK
        mesh = make_mesh()
    else:  # every rank on the one card, gloo carrying CUDA tensors
        dist.init_process_group("gloo", init_method="env://")
        mesh = make_mesh(["cuda:0"] * dist.get_world_size())
    alone = Mesh(mesh.device)
    out = {"backend": dist.get_backend(), "world": mesh.size, "device": str(mesh.device)}
    try:
        # CRW steps at bench.py:139's configuration, the batch on the card
        B, T, patch, overlap = 8, 20, (16, 16), (8, 0)
        rg, _ = synthetic_radargram(H=912, W=4096, nclasses=5, seed=13)
        ds = RGWindows(rg, length=T, dim=patch, overlap=overlap)
        seq = gather_windows(torch.as_tensor(rg, device=mesh.device), np.arange(B),
                             ds.geo).contiguous()
        cfg = CRWTrainConfig(model=1, patch_size=patch, seq_length=T, overlap=overlap,
                             batch_size=B, lr=1e-3, tau=0.01)
        trainers, losses, states = {}, {}, {}
        torch.backends.cudnn.deterministic = True  # the same kernels' sums both times
        for tag, m in (("mesh", mesh), ("alone", alone)):
            trainers[tag] = CRWTrainer(cfg, mesh=m)
            trainers[tag].init_state(tuple(seq.shape[1:]))
            losses[tag] = [float(trainers[tag].train_step(seq))]
            states[tag] = {k: v.clone() for k, v in trainers[tag].model.state_dict().items()}
            losses[tag] += [float(trainers[tag].train_step(seq)) for _ in range(2)]
        torch.backends.cudnn.deterministic = False
        out["losses"] = losses
        # after three steps; the statistics after the first, from one init
        out["params_equal"] = all(torch.equal(v, trainers["alone"].model.state_dict()[k])
                                  for k, v in trainers["mesh"].model.state_dict().items())
        stats_err = 0.0  # 1.0 = at rtol 1e-5 / atol 1e-6, the one-pass statistics' bound
        for k, v in states["alone"].items():
            if k.endswith(("running_mean", "running_var")):
                err = (states["mesh"][k] - v).abs() / (1e-6 + 1e-5 * v.abs())
                stats_err = max(stats_err, float(err.max()))
        out["stats_err"] = stats_err
        for tag, tr in trainers.items():
            for _ in range(2):
                tr.train_step(seq)
            out[f"crw_step_{tag}_ms"], out[f"crw_step_{tag}_wall_ms"] = step_times(
                lambda: tr.train_step(seq), 10)
        print(f"DP_DIGEST {mesh.rank} {dp_state_digest(trainers['mesh'].model.state_dict())}",
              flush=True)
        del trainers, states
        torch.cuda.empty_cache()

        # steps_per_dispatch = 2 on the mesh, bfloat16, fused_bn='fused': over
        # NCCL the graph captures the BatchNorm sums' and the gradients'
        # all-reduces and equals eager steps bit for bit; gloo's refuse capture
        cfg2 = dataclasses.replace(cfg, dtype=torch.bfloat16, fused_bn="fused",
                                   steps_per_dispatch=2)
        pair = [CRWTrainer(cfg2, mesh=mesh) for _ in range(2)]
        for tr in pair:
            tr.init_state(tuple(seq.shape[1:]))
        pair[1].model.load_state_dict(pair[0].model.state_dict(), strict=True)
        seqs = seq.expand(2, *seq.shape)
        torch.backends.cudnn.deterministic = True
        try:
            if backend == "nccl":
                got = torch.cat([pair[0].train_chunk(seqs) for _ in range(2)])
                want = torch.stack([pair[1].train_step(seq) for _ in range(4)])
                out["graph_losses_equal"] = torch.equal(got, want)
                out["graph_state_equal"] = all(
                    torch.equal(v, pair[1].model.state_dict()[k])
                    for k, v in pair[0].model.state_dict().items())
            else:
                try:
                    pair[0].train_chunk(seqs)
                    out["graph_refused"] = None
                except ValueError as e:
                    out["graph_refused"] = str(e)
        finally:
            torch.backends.cudnn.deterministic = False
        del pair
        torch.cuda.empty_cache()

        # the Miguel survey's forward pass with change detection
        ds, ids, refs, _, nclasses = miguel_survey()
        pipe = PropagationPipeline(
            create_model(1, False, device=mesh.device, seed=0),
            LabelPropConfig(cxt_size=100, radius=10, temperature=0.1, knn=20), nclasses,
            cache_embeddings=False, device=mesh.device)
        pipe.propagate_survey(ds, ids[:2], refs[:2], mesh=alone)  # warm-up
        survey = {}
        for tag, m in (("mesh", mesh), ("alone", alone)):
            reset_launches()
            maps, change = pipe.propagate_survey(ds, ids, refs, mesh=m, detect_change=True)
            torch.cuda.synchronize()
            survey[tag] = (maps, change, dict(labelprop_cuda.launches))
            out[f"survey_{tag}_ms"] = wall_ms(
                lambda: pipe.propagate_survey(ds, ids, refs, mesh=m), reps=3)
        out["survey_maps_equal"] = bool(np.array_equal(survey["mesh"][0], survey["alone"][0]))
        out["survey_change_equal"] = survey["mesh"][1] == survey["alone"][1]
        out["survey_shape"] = list(survey["mesh"][0].shape)
        out["survey_launches"] = {tag: v[2] for tag, v in survey.items()}
    finally:
        dist.destroy_process_group()
    if mesh.rank == 0:
        print("DP_RESULT " + json.dumps(out), flush=True)
    return 0


def data_parallel_phase(smi):
    """Phase 20: data parallel under `torch.distributed.run`: one rank over
    NCCL (its collectives over one rank are the identity: CRW steps and the
    survey's maps equal the mesh-free ones exactly), then two ranks on the
    one card over gloo with CUDA tensors, held to the one-rank results by
    the CPU tests' rules (tests/test_torch_parallel.py). NCCL refuses two
    ranks on one device; where gloo cannot run either, the reason is
    printed."""
    result = {}
    for backend, nproc in (("nccl", 1), ("gloo", 2)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(nproc), str(ROOT / "chip_smoke.py"), DP_FLAG, backend],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        res = [json.loads(ln.split(" ", 1)[1]) for ln in lines if ln.startswith("DP_RESULT ")]
        digests = {ln.split()[1]: ln.split()[2] for ln in lines if ln.startswith("DP_DIGEST ")}
        if proc.returncode != 0 or len(res) != 1 or len(digests) != nproc:
            raise SystemExit(f"data_parallel over {backend} failed (exit {proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        r = res[0]
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"]["mesh"], r["losses"]["alone"])]
        per_rank_seq = [v["prop_seq"] for v in r["survey_launches"].values()]
        phase("data_parallel", f"{r['backend']} world {r['world']} on {r['device']}: CRW steps "
              f"losses {r['losses']['mesh']} vs alone {r['losses']['alone']} (rel "
              f"{', '.join(f'{x:.2e}' for x in rel)}), params after 3 steps equal "
              f"{r['params_equal']}, running stats after step 1 at {r['stats_err']:.3f} of "
              f"rtol 1e-5 / atol 1e-6, ranks' states equal "
              f"{len(set(digests.values())) == 1}; {r['crw_step_mesh_ms']:.2f} ms a step on the "
              f"mesh vs {r['crw_step_alone_ms']:.2f} alone (events, median of 10); survey "
              f"{r['survey_shape']} maps equal {r['survey_maps_equal']}, change indices equal "
              f"{r['survey_change_equal']}, prop_seq launches (mesh, alone) {per_rank_seq}, "
              f"{r['survey_mesh_ms']:.2f} ms vs {r['survey_alone_ms']:.2f} ms wall; {wall:.1f} s")
        if backend == "nccl":
            graph_ok = r["graph_losses_equal"] and r["graph_state_equal"]
            graph_msg = (f"steps_per_dispatch 2 over NCCL (bf16, fused_bn='fused'): graph vs "
                         f"eager losses equal {r['graph_losses_equal']}, states equal "
                         f"{r['graph_state_equal']}")
        else:
            graph_ok = bool(r["graph_refused"]) and "gloo" in r["graph_refused"]
            graph_msg = f"steps_per_dispatch 2 over gloo refused: {r['graph_refused']!r}"
        phase("data_parallel", graph_msg)
        ok = (r["survey_maps_equal"] and r["survey_change_equal"] and per_rank_seq == [1, 1]
              and len(set(digests.values())) == 1 and graph_ok)
        if r["world"] == 1:  # an all-reduce over one rank is the identity
            ok = ok and r["params_equal"] and r["losses"]["mesh"] == r["losses"]["alone"]
        else:  # one step from one init, as tests/test_torch_parallel.py holds it; later
            # steps are printed, not held: Adam's first update turns float noise in
            # gradients near zero into jumps of up to lr
            ok = ok and rel[0] <= 1e-5 and r["stats_err"] <= 1.0
        if not ok:
            raise SystemExit(f"data_parallel over {backend}: the mesh disagrees with one device")
        result[f"{backend}_{nproc}rank"] = {**r, "loss_rel": rel, "wall_s": wall}
    phase("times", f"{smi} | " + " ".join(
        f"{k}_{m}={v[m]:.4f}" for k, v in result.items()
        for m in ("crw_step_mesh_ms", "crw_step_alone_ms", "survey_mesh_ms", "survey_alone_ms")))
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from radar_sounder_crw_tpu_torch.data import (
        extract_window,
        synthetic_radargram,
        window_geometry,
    )
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
    from radar_sounder_crw_tpu_torch.infer.propagate import seed_onehot_from_segmentation
    from radar_sounder_crw_tpu_torch.models import create_model
    from radar_sounder_crw_tpu_torch.ops import bn_cuda  # noqa: F401 (registers its source)
    from radar_sounder_crw_tpu_torch.ops import cuda_build, labelprop_cuda
    from radar_sounder_crw_tpu_torch.ops.labelprop import (
        LabelPropConfig,
        _affinity,
        _chunk_lists,
        _prop_step,
        propagate_labels,
    )
    from radar_sounder_crw_tpu_torch.utils import parity_mode, resize_nearest

    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    parity_mode()

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build(verbose=True)
    if sorted(libs) != sorted([*labelprop_cuda.NAMES, "bn_train"]):
        raise SystemExit(f"the build made {sorted(libs)}")
    phase("build", f"ok {sorted(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")

    # 2. kernel vs plain at step shapes ---------------------------------------
    cases = [
        # name, K, N, C, M, knn, radius, temperature, nslots, ties
        ("mc3", 101, 190, 128, 6, 20, 60, 0.01, 101, False),
        ("mc3_prefix", 101, 190, 128, 6, 20, 60, 0.01, 37, False),
        ("sharad", 101, 113, 128, 5, 20, 10, 0.1, 101, False),
        ("sharad_ties", 101, 113, 128, 5, 20, 10, 0.1, 64, True),
        ("knn_over_candidates", 4, 5, 8, 3, 30, 3, 0.07, 2, False),
        ("odd_channels", 7, 30, 7, 4, 9, 5, 0.07, 7, False),
        ("n400", 160, 400, 64, 4, 20, 30, 0.05, 160, False),
        ("mc3_t1", 101, 190, 128, 6, 20, 60, 0.01, 2, False),
        ("mc3_t2", 101, 190, 128, 6, 20, 60, 0.01, 3, False),
        ("mc3_t37", 101, 190, 128, 6, 20, 60, 0.01, 38, False),
    ]
    mc3_err = 0.0
    for i, (name, K, N, C, M, knn, radius, temp, nslots, ties) in enumerate(cases):
        feats, query, mask, bias, labels = step_inputs(K, N, C, M, radius, nslots, i, ties)
        got = labelprop_cuda.prop_step(feats, query, mask, bias, labels, temp, knn, nslots)
        want = _prop_step(feats, query, mask, bias, labels, temp, knn, nslots)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same_argmax = torch.equal(got.argmax(-1), want.argmax(-1))
        bitwise = torch.equal(got, want)
        phase("kernel_vs_plain", f"{name} K={K} N={N} C={C} M={M} knn={knn} "
              f"nslots={nslots}: max_abs_err={err:.3e} argmax_equal={same_argmax} "
              f"bitwise={bitwise}")
        if not (torch.isfinite(got).all() and err <= STEP_ATOL and same_argmax
                and (bitwise or not ties)):
            raise SystemExit(f"kernel disagrees with the plain step on {name}")
        if name.startswith("mc3"):
            mc3_err = max(mc3_err, err)
        if ties:  # step 1 alone: the chunk lists, exactly
            rows = labelprop_cuda.step_chunk_rows(N, knn, nslots, "cuda")
            vals, idx = labelprop_cuda.prop_step_tiles(feats, query, mask, bias, temp, knn,
                                                       nslots, rows)
            flat = _affinity(feats[None], query[None], mask, bias, temp, nslots)
            want_v, want_i = _chunk_lists(flat, knn, rows)
            lists_equal = (torch.equal(vals, want_v[0])
                           and torch.equal(idx.long(), want_i[0]))
            phase("kernel_vs_plain", f"{name}: step 1 chunk lists ({vals.shape[1]} chunks of "
                  f"{rows} candidates) equal to the twin's: {lists_equal}")
            if not lists_equal:
                raise SystemExit(f"prop_step's chunk lists differ from the twin's on {name}")

    # 3. MC3 seed->map at full width ----------------------------------------
    T, hw, overlap, nclasses = 100, (32, 32), (30, 0), 6
    rg, seg = synthetic_radargram(H=410, W=3200, nclasses=nclasses)
    geo = window_geometry(rg.shape, hw, overlap, T)
    seq = torch.as_tensor(extract_window(rg, geo, 0), device="cuda")
    N = geo.nh
    assert seq.shape == (T, N, *hw) and N == 190, seq.shape
    seg_ref = seg[: geo.rg_h(), : geo.w]
    reseed_frame = 40
    c0 = geo.col_start(reseed_frame)
    seg_ref2 = seg[: geo.rg_h(), c0 : c0 + geo.w]
    cfg = LabelPropConfig(cxt_size=100, radius=60, temperature=0.01, knn=20)
    model = create_model(1, False, device="cuda", seed=0)
    pipe = PropagationPipeline(model, cfg, nclasses)  # kernel="auto": the main path
    named = PropagationPipeline(model, cfg, nclasses, kernel="cuda")  # prop_step by name
    plain = PropagationPipeline(model, cfg, nclasses, kernel="torch")
    pipe(seq, seg_ref)  # warm-up: cuDNN algorithm choice, allocator
    named(seq, seg_ref)

    reset_launches()
    res = pipe(seq, seg_ref, detect_change=True, return_soft=True)
    res_re = pipe.reseed(seg_ref2, reseed_frame)
    torch.cuda.synchronize()
    mc3_launches = dict(labelprop_cuda.launches)
    phase("seed_to_map", f"main path (auto): launches {mc3_launches} (expected prop_seq 2: "
          f"seed->map, reseed), change_idx={res.change_idx}")
    if (mc3_launches["prop_seq"] != 2 or mc3_launches["prop_step"]
            or mc3_launches["prop_all"]):
        raise SystemExit("the main path did not launch prop_seq once per seed->map and reseed")

    reset_launches()
    res_cuda = named(seq, seg_ref, detect_change=True, return_soft=True)
    res_cuda_re = named.reseed(seg_ref2, reseed_frame)
    torch.cuda.synchronize()
    named_launches = dict(labelprop_cuda.launches)
    want_named = (T - 1) + (-(-(T - reseed_frame) // 16) * 16 - 1)
    phase("seed_to_map", f"kernel='cuda' by name: launches {named_launches} (expected "
          f"prop_step {want_named}), change_idx={res_cuda.change_idx}")
    if (named_launches["prop_step"] != want_named
            or sum(named_launches.values()) != want_named):
        raise SystemExit("kernel='cuda' did not launch prop_step once per frame")

    ref = plain(seq, seg_ref, detect_change=True, return_soft=True)
    ref_re = plain.reseed(seg_ref2, reseed_frame)
    agree = float((res.prediction == ref.prediction).mean())
    agree_re = float((res_re.prediction == ref_re.prediction).mean())
    agree_cuda = float((res_cuda.prediction == ref.prediction).mean())
    agree_cuda_re = float((res_cuda_re.prediction == ref_re.prediction).mean())
    gt = resize_nearest(seg[: geo.rg_h(), : geo.rg_len()], (N, T))
    acc = float((res.prediction == gt).mean())
    phase("seed_to_map", f"auto vs plain: map agreement={agree:.5f} reseed "
          f"agreement={agree_re:.5f} change_idx {res.change_idx} vs {ref.change_idx}; "
          f"cuda vs plain: map agreement={agree_cuda:.5f} reseed agreement="
          f"{agree_cuda_re:.5f} change_idx {res_cuda.change_idx}; "
          f"accuracy vs ground truth {acc:.4f} (random weights)")
    checks = {
        "prediction shape": res.prediction.shape == (N, T),
        "soft shape/finite": res.soft.shape == (T, N, nclasses) and np.isfinite(res.soft).all(),
        "xent shape/finite": res.xent.shape == (N, T - 1) and np.isfinite(res.xent).all(),
        "soft argmax == map": np.array_equal(res.soft.argmax(-1).T, res.prediction),
        "reseed keeps prefix": np.array_equal(
            res_re.prediction[:, :reseed_frame], res.prediction[:, :reseed_frame]),
        "reseed seeds its frame": np.array_equal(
            res_re.prediction[:, reseed_frame],
            seed_onehot_from_segmentation(seg_ref2, N, nclasses)[1]),
        "map agreement": agree >= MAP_AGREEMENT,
        "reseed agreement": agree_re >= MAP_AGREEMENT,
        "change_idx equal": res.change_idx == ref.change_idx,
        "cuda map agreement": agree_cuda >= MAP_AGREEMENT,
        "cuda reseed agreement": agree_cuda_re >= MAP_AGREEMENT,
        "cuda change_idx equal": res_cuda.change_idx == ref.change_idx,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"seed->map checks failed: {failed}")
    phase("seed_to_map", "ok: " + ", ".join(checks))

    # 4. times ----------------------------------------------------------------
    emb = pipe.encode(seq)
    seed_np, _ = seed_onehot_from_segmentation(seg_ref, N, nclasses)
    times = {
        "encode_ms": wall_ms(lambda: pipe.encode(seq)),
        "propagate_ms": wall_ms(lambda: propagate_labels(emb, seed_np, cfg)),
        "propagate_cuda_ms": wall_ms(lambda: propagate_labels(emb, seed_np, cfg, kernel="cuda")),
        "propagate_plain_ms": wall_ms(lambda: propagate_labels(emb, seed_np, cfg, kernel="torch")),
        "seed_to_map_ms": wall_ms(
            lambda: pipe(seq, seg_ref, detect_change=False, fetch_xent=False)),
        "seed_to_map_detect_ms": wall_ms(lambda: pipe(seq, seg_ref)),
        "reseed_ms": wall_ms(lambda: pipe.reseed(seg_ref2, reseed_frame)),
        "seed_to_map_cuda_ms": wall_ms(
            lambda: named(seq, seg_ref, detect_change=False, fetch_xent=False)),
        "reseed_cuda_ms": wall_ms(lambda: named.reseed(seg_ref2, reseed_frame)),
    }
    K, C, M, knn = 101, 128, nclasses, 20
    feats, query, mask, bias, labels = step_inputs(K, N, C, M, 60, K, 0)
    args = (feats, query, mask, bias, labels, 0.01, knn, K)
    kernel_ms = cuda_ms(lambda: labelprop_cuda.prop_step(*args), iters=50)
    # the same launch device-only: 50 calls in one CUDA graph, its replays
    # timed (the inputs stay in the L2, as in the eager loop above)
    kernel_device_ms = graph_ms(lambda i: labelprop_cuda.prop_step(*args), 1, calls=50)
    plain_ms = cuda_ms(lambda: _prop_step(*args), iters=20)
    f2d = feats.reshape(K * N, C)
    matmul_ms = cuda_ms(lambda: torch.matmul(f2d, query.T), iters=50)
    ops, nbytes = step_flops_bytes(K, N, C, M, knn, K)
    bound_ms, bound_by = bound(ops, nbytes)

    # the kernel's share of one seed->map: the 99 launches of kernel="cuda",
    # each over its valid prefix of 1 + min(t, 100) slots
    nslots_path = [1 + min(t, 100) for t in range(1, T)]

    def path_launches():
        for ns in nslots_path:
            labelprop_cuda.prop_step(feats, query, mask, bias, labels, 0.01, knn, ns)

    path_kernel_ms = cuda_ms(path_launches, iters=3, warmup=1)

    # the host's share of a prop_step call: the same 99 calls queued behind
    # matmuls that outlast their enqueueing, so the card runs them back to
    # back and the events around them read device time alone
    path_wall_ms = wall_ms(path_launches)
    big = torch.randn((8192, 8192), device="cuda")
    matmul_block_ms = cuda_ms(lambda: big @ big, iters=2, warmup=1)
    n_block = int(3 * path_wall_ms / matmul_block_ms) + 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_block):
        big @ big
    start.record()
    path_launches()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    path_device_ms = start.elapsed_time(end)
    if enqueue_ms >= n_block * matmul_block_ms:
        raise SystemExit("the prop_step launches were not all queued before the card reached them")
    del big
    path_ops = sum(step_flops_bytes(K, N, C, M, knn, ns)[0] for ns in nslots_path)
    path_bound_ms = path_ops / PEAK_F32_FLOPS * 1e3

    # the first step (block top-k lists) alone; the merge is the difference
    def tiles(ns):
        labelprop_cuda.prop_step_tiles(feats, query, mask, bias, 0.01, knn, ns,
                                       labelprop_cuda.step_chunk_rows(N, knn, ns, "cuda"))

    tile_ms = cuda_ms(lambda: tiles(K), iters=50)
    path_tile_ms = cuda_ms(lambda: [tiles(ns) for ns in nslots_path], iters=3, warmup=1)
    times.update({
        "kernel_ms_per_launch": kernel_ms,
        "kernel_device_ms_per_launch": kernel_device_ms,
        "kernel_tile_ms_per_launch": tile_ms,
        "kernel_merge_ms_per_launch": kernel_ms - tile_ms,
        "kernel_bound_share": bound_ms / kernel_ms,
        "kernel_us_per_frame_on_path": path_kernel_ms / len(nslots_path) * 1e3,
        "kernel_ms_per_seed_to_map": path_kernel_ms,
        "kernel_tile_ms_per_seed_to_map": path_tile_ms,
        "kernel_merge_ms_per_seed_to_map": path_kernel_ms - path_tile_ms,
        "kernel_bound_ms_per_seed_to_map": path_bound_ms,
        "kernel_bound_share_per_seed_to_map": path_bound_ms / path_kernel_ms,
        "prop_step_wall_us_per_call": path_wall_ms / len(nslots_path) * 1e3,
        "prop_step_device_us_per_call": path_device_ms / len(nslots_path) * 1e3,
        "prop_step_host_us_per_call": (path_wall_ms - path_device_ms) / len(nslots_path) * 1e3,
        "propagate_non_kernel_us_per_frame":
            (times["propagate_cuda_ms"] - path_device_ms) / len(nslots_path) * 1e3,
        "plain_step_ms": plain_ms,
        "affinity_matmul_ms": matmul_ms,
    })
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in times.items())
          + f" | path GFLOP={path_ops / 1e9:.2f}")

    # 5. prop_seq vs its plain twin ------------------------------------------
    from radar_sounder_crw_tpu_torch.ops.labelprop import (
        _winners_all_frames,
        propagate_seq_reference,
        radius_mask,
    )

    seq_cases = [
        # name, B, T, N, C, M, cxt, radius, temperature, knn, long_mem, ties
        ("survey", 63, 100, 50, 128, 6, 100, 10, 0.1, 20, (0,), False),
        ("mc3_width", 2, 100, 190, 128, 6, 100, 60, 0.01, 20, (0,), False),
        ("wrap_pins", 3, 12, 24, 32, 4, 4, 5, 0.07, 6, (0, 2), False),
        ("knn_over_candidates", 2, 6, 5, 8, 3, 2, 3, 0.07, 40, (0,), False),
        ("ties", 4, 30, 50, 128, 6, 10, 10, 0.1, 20, (0, 3), True),
        ("single_frame", 2, 1, 50, 128, 6, 100, 10, 0.1, 20, (0,), False),
    ]
    seq_err = 0.0
    for i, (name, B, Ts, Ns, Cs, Ms, cxt, radius, temp, knn_s, lm, ties) in enumerate(seq_cases):
        e, s0 = seq_inputs(B, Ts, Ns, Cs, Ms, 100 + i, ties)
        m = torch.as_tensor(radius_mask(Ns, 1, radius), device="cuda")
        knn_s = min(knn_s, (len(lm) + cxt) * Ns)
        before = labelprop_cuda.launches["prop_seq"]
        got = labelprop_cuda.prop_seq(e, s0, m, lm, cxt, temp, knn_s)
        n_launch = labelprop_cuda.launches["prop_seq"] - before
        want = propagate_seq_reference(e, s0, m, lm, cxt, temp, knn_s)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same_argmax = torch.equal(got.argmax(-1), want.argmax(-1))
        phase("seq_vs_plain", f"{name} B={B} T={Ts} N={Ns} C={Cs} M={Ms} cxt={cxt} "
              f"knn={knn_s} long_mem={lm}: max_abs_err={err:.3e} argmax_equal={same_argmax} "
              f"bitwise={torch.equal(got, want)} launches={n_launch}")
        # grid or dyadic values: every product is exact, the results equal bit for bit
        if not (torch.isfinite(got).all() and err <= STEP_ATOL and same_argmax
                and n_launch == (1 if Ts > 1 else 0) and torch.equal(got, want)):
            raise SystemExit(f"prop_seq disagrees with its plain twin on {name}")
        if name == "survey":
            seq_err = err
        if ties:  # phase A alone: every frame's winner lists, exactly
            src, e_got = labelprop_cuda.prop_seq_select(e, m, lm, cxt, temp, knn_s)
            f_got, i_got = labelprop_cuda.unpack_sources(src.long(), Ns)
            f_want, i_want, e_want = _winners_all_frames(e, m, lm, cxt, temp, knn_s)
            lists_equal = (torch.equal(f_got, f_want) and torch.equal(i_got, i_want)
                           and torch.equal(e_got, e_want))
            phase("seq_vs_plain", f"{name}: phase A lists {tuple(src.shape)} equal to "
                  f"_winners_all_frames: {lists_equal}")
            if not lists_equal:
                raise SystemExit(f"prop_seq's phase A lists differ from the twin's on {name}")
    soft_seq, pred_seq = propagate_labels(emb, seed_np, cfg, kernel="cuda_seq")
    soft_frame, pred_frame = propagate_labels(emb, seed_np, cfg, kernel="cuda")
    agree_seq = float((pred_seq == pred_frame).float().mean())
    phase("seq_vs_plain", f"MC3 window, cuda_seq (B=1) vs cuda: map agreement={agree_seq:.5f}, "
          f"max |soft diff|={(soft_seq - soft_frame).abs().max().item():.3e}")
    if agree_seq < MAP_AGREEMENT:
        raise SystemExit("cuda_seq disagrees with the per-frame cuda path on the MC3 window")

    # 6. prop_all vs its plain twin, and the cuda_resident route on MC3 -------
    from radar_sounder_crw_tpu_torch.ops.labelprop import (
        _weights_all_frames,
        propagate_all_reference,
    )

    resident_cases = [*seq_cases[:3], ("no_pins", 2, 12, 24, 32, 4, 4, 5, 0.07, 6, (), False),
                      *seq_cases[3:]]
    resident_err = 0.0
    for i, (name, B, Ts, Ns, Cs, Ms, cxt, radius, temp, knn_s, lm, ties) in enumerate(
            resident_cases):
        e, s0 = seq_inputs(B, Ts, Ns, Cs, Ms, 200 + i, ties)
        m = torch.as_tensor(radius_mask(Ns, 1, radius), device="cuda")
        before = labelprop_cuda.launches["prop_all"]
        got = labelprop_cuda.prop_all(e, s0, m, lm, cxt, temp, knn_s)
        n_launch = labelprop_cuda.launches["prop_all"] - before
        want = propagate_all_reference(e, s0, m, lm, cxt, temp, knn_s)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        bitwise = torch.equal(got, want)
        same_argmax = torch.equal(got.argmax(-1), want.argmax(-1))
        phase("resident_vs_plain", f"{name} B={B} T={Ts} N={Ns} C={Cs} M={Ms} cxt={cxt} "
              f"knn={knn_s} long_mem={lm}: max_abs_err={err:.3e} argmax_equal={same_argmax} "
              f"bitwise={bitwise} launches={n_launch}")
        if not (torch.isfinite(got).all() and bitwise and same_argmax
                and n_launch == (1 if Ts > 1 else 0)):
            raise SystemExit(f"prop_all differs from its plain twin on {name}")
        resident_err = max(resident_err, err)
        if ties or name == "wrap_pins":  # the lists alone: weights in row order, exactly
            src, w_got = labelprop_cuda.prop_all_weights(e, m, lm, cxt, temp, knn_s)
            f_got, i_got = labelprop_cuda.unpack_sources(src.long(), Ns)
            f_want, i_want, w_want = _weights_all_frames(e, m, lm, cxt, temp, knn_s)
            lists_equal = (torch.equal(f_got, f_want) and torch.equal(i_got, i_want)
                           and torch.equal(w_got, w_want))
            phase("resident_vs_plain", f"{name}: weight lists {tuple(src.shape)} equal to "
                  f"_weights_all_frames: {lists_equal}")
            if not lists_equal:
                raise SystemExit(f"prop_all's weight lists differ from the twin's on {name}")
        if name == "survey":  # the other weight arithmetic, same winners
            other = labelprop_cuda.prop_seq(e, s0, m, lm, cxt, temp, knn_s)
            diff = (got - other).abs().max().item()
            agree_other = (got.argmax(-1) == other.argmax(-1)).float().mean().item()
            phase("resident_vs_plain", f"survey: prop_all vs prop_seq max |soft diff|="
                  f"{diff:.3e} map agreement={agree_other:.5f}")
            if diff > 1e-5 or agree_other < MAP_AGREEMENT:
                raise SystemExit("prop_all disagrees with prop_seq at the survey shape")

    resident = PropagationPipeline(model, cfg, nclasses, kernel="cuda_resident")
    resident(seq, seg_ref)  # warm-up
    reset_launches()
    res_r = resident(seq, seg_ref, detect_change=True, return_soft=True)
    res_r_re = resident.reseed(seg_ref2, reseed_frame)
    torch.cuda.synchronize()
    resident_mc3 = dict(labelprop_cuda.launches)
    agree_r = float((res_r.prediction == res.prediction).mean())
    agree_r_re = float((res_r_re.prediction == res_re.prediction).mean())
    phase("seed_to_map_resident", f"cuda_resident path: launches {resident_mc3} (expected "
          f"prop_all 2: seed->map, reseed); vs the main path: map agreement={agree_r:.5f} "
          f"reseed agreement={agree_r_re:.5f} change_idx {res_r.change_idx} vs "
          f"{res.change_idx}")
    checks = {
        "one prop_all launch each": resident_mc3["prop_all"] == 2
        and sum(resident_mc3.values()) == 2,
        "soft finite": np.isfinite(res_r.soft).all(),
        "map agreement": agree_r >= MAP_AGREEMENT,
        "reseed agreement": agree_r_re >= MAP_AGREEMENT,
        "change_idx equal": res_r.change_idx == res.change_idx,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"cuda_resident seed->map checks failed: {failed}")
    seed_t = torch.as_tensor(seed_np, device="cuda")[None]
    args_mc3 = (emb[None].contiguous(), seed_t, torch.as_tensor(radius_mask(N, 1, 60),
                device="cuda"), (0,), 100, 0.01, knn)
    mc3_ops, mc3_bytes = seq_flops_bytes(1, T, N, C, M, knn, 1, 100)
    resident_times = {
        "seed_to_map_resident_ms": wall_ms(
            lambda: resident(seq, seg_ref, detect_change=False, fetch_xent=False)),
        "reseed_resident_ms": wall_ms(lambda: resident.reseed(seg_ref2, reseed_frame)),
        "prop_all_mc3_ms_per_launch": cuda_ms(
            lambda: labelprop_cuda.prop_all(*args_mc3), iters=5, warmup=1),
        "prop_all_mc3_plain_twin_ms": cuda_ms(
            lambda: propagate_all_reference(*args_mc3), iters=2, warmup=1),
        "prop_all_mc3_bound_ms": bound(mc3_ops, mc3_bytes)[0],
        **resident_split_ms(args_mc3, "prop_all_mc3"),
    }
    resident_times["prop_seq_select_mc3_b1_ms"] = resident_times["prop_all_mc3_select_ms"]
    # the same selection for 4 radargrams: what B = 1 loses to its last frames' long CTAs
    emb4 = args_mc3[0].expand(4, -1, -1, -1).contiguous()
    resident_times["prop_seq_select_mc3_b4_ms"] = cuda_ms(
        lambda: labelprop_cuda.prop_seq_select(emb4, *args_mc3[2:]), iters=10, warmup=2)
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in resident_times.items()))
    times.update(resident_times)

    # 7-8. the Miguel survey at full width ---------------------------------------
    survey_main, survey_resident, seq_bound_by, survey_times = survey_phase(smi)
    if mc3_launches["prop_all"] + survey_main["prop_all"] != 0:
        raise SystemExit("kernel='auto' reached prop_all")

    # 9-11. auto past the limits, the entry points -----------------------------
    auto_launches = auto_limits_phase()
    cli_launches, cli_times = cli_phase()
    annotate_launches, annotate_ms = annotate_phase()
    cli_times.update(annotate_ms)
    route_b1 = route_b1_phase(smi)
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in cli_times.items()))

    # 12-18. training -------------------------------------------------------------
    train_times = train_vs_cpu_phase()
    bn = bn_kernels_phase(smi, BENCH["B"] * BENCH["T"] * 113)
    crw_times, bn_launches = crw_step_phase(smi)
    train_times.update(crw_times)
    cli_train_times, pts = train_cli_phase()
    train_times.update(cli_train_times)
    launch_times = launch_phase()
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in launch_times.items()))
    train_times.update(trained_inference_phase(pts))
    train_times.update(unet_phase(smi))

    # 19-20. the tuner, data parallel -----------------------------------------------
    train_times.update(tune_phase())
    parallel = data_parallel_phase(smi)

    # 21. results ---------------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "prop_step",
        "route": "cuda",
        "source": "radar_sounder_crw_tpu_torch/csrc/prop_step.cu",
        "replaces": "radar_sounder_crw_tpu/ops/labelprop_pallas.py:466",
        "launches": mc3_launches["prop_step"],  # the main path's: none since auto takes prop_seq
        "launches_named_cuda": named_launches["prop_step"],
        "max_abs_err": mc3_err,
        "ms": kernel_ms,
        "device_ms": kernel_device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "affinity_matmul_ms": matmul_ms,
        "tile_ms": times["kernel_tile_ms_per_launch"],
        "merge_ms": times["kernel_merge_ms_per_launch"],
        "ms_per_seed_to_map": times["kernel_ms_per_seed_to_map"],
        "bound_ms_per_seed_to_map": times["kernel_bound_ms_per_seed_to_map"],
        "launches_annotate": annotate_launches["prop_step"],
        "launches_cli_test_all": cli_launches["prop_step"],
        "launches_auto_limits": auto_launches["prop_step"],
    }, {
        "name": "prop_seq",
        "route": "cuda",
        "source": "radar_sounder_crw_tpu_torch/csrc/prop_seq.cu",
        "replaces": "radar_sounder_crw_tpu/ops/labelprop_pallas.py:939",
        "launches": survey_main["prop_seq"],
        "max_abs_err": seq_err,
        "ms": survey_times["prop_seq_ms_per_launch"],
        "plain_ms": survey_times["plain_twin_ms"],
        "bound_ms": survey_times["prop_seq_bound_ms"],
        "bound_by": seq_bound_by,
        "library_ms": None,
        "affinity_bmm_ms": survey_times["affinity_bmm_ms"],
        "phase_a_ms": survey_times["prop_seq_phase_a_ms"],
        "phase_b_ms": survey_times["prop_seq_phase_b_ms"],
        "launches_cli_test_all": cli_launches["prop_seq"],
        "launches_annotate": annotate_launches["prop_seq"],
        "launches_seed_to_map": mc3_launches["prop_seq"],
        "launches_auto_limits": auto_launches["prop_seq"],
    }, {
        "name": "prop_all",
        "route": "cuda",
        "source": "radar_sounder_crw_tpu_torch/csrc/prop_all.cu",
        "replaces": "radar_sounder_crw_tpu/ops/labelprop_pallas.py:1320",
        # 'auto' never routes to it; the cuda_resident path's own count beside
        "launches": mc3_launches["prop_all"] + survey_main["prop_all"],
        "launches_cuda_resident_path": resident_mc3["prop_all"] + survey_resident["prop_all"],
        "max_abs_err": resident_err,
        "ms": survey_times["prop_all_ms_per_launch"],
        "plain_ms": survey_times["prop_all_plain_twin_ms"],
        "bound_ms": survey_times["prop_seq_bound_ms"],
        "bound_by": seq_bound_by,
        "library_ms": None,
        "affinity_bmm_ms": survey_times["affinity_bmm_ms"],
        "select_ms": survey_times["prop_all_select_ms"],
        "weights_ms": survey_times["prop_all_weights_ms"],
        "chain_ms": survey_times["prop_all_chain_ms"],
        "ms_mc3_b1": times["prop_all_mc3_ms_per_launch"],
        "select_ms_mc3_b1": times["prop_all_mc3_select_ms"],
        "weights_ms_mc3_b1": times["prop_all_mc3_weights_ms"],
        "chain_ms_mc3_b1": times["prop_all_mc3_chain_ms"],
        "plain_ms_mc3_b1": times["prop_all_mc3_plain_twin_ms"],
        "bound_ms_mc3_b1": times["prop_all_mc3_bound_ms"],
        "launches_cli_test_all": cli_launches["prop_all"],
        "launches_annotate": annotate_launches["prop_all"],
        "launches_auto_limits": auto_launches["prop_all"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "radar_sounder_crw_tpu_torch/csrc/bn_train.cu",
        "design": {"bn_stats": "tiled reduction, one launch", "bn_apply": "tiled",
                   "bn_backward_reduce": "tiled reduction, one launch",
                   "bn_dx": "(tile, sample chunk) grid, scalar loads"}[name],
        # the jax.custom_vjp's forward (_bn_train_impl) and backward (_bn_train_bwd)
        "replaces": "radar_sounder_crw_tpu/models/fused_bn.py:"
                    + ("58" if name in ("bn_stats", "bn_apply") else "76"),
        # the main path: 20 bfloat16 steps of the bench configuration, fused_bn='fused'
        "launches": bn_launches["bf16_fused"][name],
        "launches_f32_fused": bn_launches["f32_fused"][name],
        "launches_lean": {k: v[name] for k, v in bn_launches.items() if k.endswith("lean")},
        "max_abs_err": bn["max_abs_err"][name],
        # a step's 13 BatchNorm shapes, summed; bfloat16 (float32 beside)
        "ms": bn["totals"]["bf16"][f"{name}_ms"],
        "plain_ms": bn["totals"]["bf16"][f"{name}_plain_ms"],
        "bound_ms": bn["totals"]["bf16"][f"{name}_bound_ms"],
        "bound_by": "bytes",
        "library_ms": bn["totals"]["bf16"][f"{name}_library_ms"],
        "ms_f32": bn["totals"]["f32"][f"{name}_ms"],
        "plain_ms_f32": bn["totals"]["f32"][f"{name}_plain_ms"],
        "bound_ms_f32": bn["totals"]["f32"][f"{name}_bound_ms"],
        "library_ms_f32": bn["totals"]["f32"][f"{name}_library_ms"],
        # device-only (phase 12b's graphs): the kernel's and the library call's
        "device_ms": bn["totals"]["bf16"][f"{name}_device_ms"],
        "device_ms_f32": bn["totals"]["f32"][f"{name}_device_ms"],
        "library_device_ms": bn["totals"]["bf16"][f"{name}_device_library_ms"],
        "library_device_ms_f32": bn["totals"]["f32"][f"{name}_device_library_ms"],
    } for name in BN_KERNELS], "bn_totals": bn["totals"], "times": times, "survey_times": survey_times, "cli_times": cli_times,
        "train_times": train_times, "launch_times": launch_times, "data_parallel": parallel,
        "route_b1": route_b1}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == DP_FLAG:
        sys.exit(dp_rank_main(sys.argv[2]))
    sys.exit(main())
