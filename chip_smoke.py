"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. build the three CUDA propagation kernels, csrc/prop_step.cu,
     csrc/prop_seq.cu and csrc/prop_all.cu, all on the tile core
     csrc/prop_tile.cuh, the last two on the all-frames kernels of
     csrc/prop_frames.cuh (sm_90a, one nvcc each, started together);
  2. hold prop_step against its plain PyTorch twin at MC3 and SHARAD step
     shapes, the MC3 prefixes of frames t = 1, 2, 37 and 100, a tie-heavy
     case (bit for bit), knn above the candidate count, an odd channel
     count and N = 400 (seven query tiles): pred to 1e-4 absolute, argmax
     exactly equal; then its first step's chunk lists against the twin's
     (`_chunk_lists`) on the tie-heavy case, exactly;
  3. MC3 seed->map at full width (ResNet-10 float32, TF32 off) on a
     synthetic 410 x 3200 radargram, one 32x32 window with overlap (30, 0):
     T = 100 frames of N = 190 nodes, seeded from the first 32 columns,
     change detection on, then one reseed at frame 40; the CUDA kernel path
     against the plain path: >= 99.5 % equal maps, equal change_idx;
  4. times on the card: encode, propagate, seed->map and reseed wall ms,
     the kernel per launch and per seed->map (CUDA events), split into its
     tile and merge steps, with the share of the bound, the plain step,
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
  7. the Miguel survey at full width, as `scripts/test_all.py --batched
     --correction --correction_tail --use_last` runs it: 63 windows of
     T = 100 frames, N = 50, of the synthetic 410 x 105120 line; forward
     with change detection, the correction tails bucketed by length, the
     reverse pass and the flat MCORDS3 merge. On every pass the
     whole-sequence kernel route against the plain route: >= 99.5 % equal
     maps, equal change indices; the device-gathered survey equal to
     propagate_batch on host-staged windows; prop_seq launched once per
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
     --model 1 --batched --correction --use_last --no_plots
     --allow_untrained` (the synthetic Miguel line, seq_length 100, 16x16
     patches, overlap (8, 0), cxt 100, radius 10, temperature 0.1, knn 20),
     once as it is and once with --kernel torch: exit 0, `mIoU:` printed,
     >= 99.5 % equal predicted maps, each run's wall time; then the same
     arguments through cli.test_all.main in this process for the launches
     of the default route, prop_seq once per survey call (forward, each
     correction bucket, reverse);
 11. annotate: `python -m radar_sounder_crw_tpu_torch.cli.annotate
     --dataset 3 --allow_untrained` over stdin: load window 0, seed from the
     ground truth, reseed at frame 40, metrics, info, quit; every reply ok,
     the seed's and the reseed's wall ms; then the same session in this
     process for its prop_step launches;
 12. a JSON line describing each kernel, the card's name and power limit,
     and the final {"ok": true, ...} line.

Launch counts are set to 0 just before each path is driven and read just
after it: the default main path (phases 3 and 7), the cuda_resident one,
the auto_limits call and the two entry points of phases 10 and 11.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
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
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda

    for name in labelprop_cuda.launches:
        labelprop_cuda.launches[name] = 0


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


def device_busy(fn):
    """Device time by kernel name over one call of fn under torch.profiler:
    the device's busy share of the call's wall time and the largest kernels
    (ms). A trace without device time reports a busy share of 0."""
    from torch.profiler import ProfilerActivity, profile

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


def survey_phase(smi):
    """Phases 7 and 8: the full-width Miguel survey through the product
    entry point, on the whole-sequence kernels and on the plain route.
    Returns (launches by kernel on the survey's main path, launches by
    kernel on the cuda_resident path, what bounds the whole-sequence
    kernels, times)."""
    from radar_sounder_crw_tpu_torch.data import create_dataset, get_reference
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

    T, patch, overlap = 100, (16, 16), (8, 0)
    t0 = time.perf_counter()
    ds = create_dataset(id=1, length=T, dim=patch, overlap=overlap, full=True)
    geo = ds.geo
    N = geo.nh
    nclasses, seg = get_reference(id=1, h=N * patch[0], w=0, length=T, dim=patch)
    rg_len, rg_h = geo.rg_len(), geo.rg_h()
    R = seg.shape[-1] // rg_len
    seg = seg[:, : R * rg_len]
    ids = list(range(0, len(ds), T))[:R]
    refs = [seg[:rg_h, rg_len * t : rg_len * t + patch[1]] for t in range(R)]
    if (R, N, len(ids)) != (63, 50, 63):
        raise SystemExit(f"survey geometry R={R} N={N} windows={len(ids)}, expected 63/50/63")
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
    staged = pipe.propagate_batch(np.stack([ds[i] for i in ids]), refs)
    checks = {
        "prediction shape": preds.shape == (R, N, T),
        "device gather == host-staged": np.array_equal(staged, preds),
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
CLI_ARGS = ["--dataset", "1", "--model", "1", "--batched", "--correction", "--use_last",
            "--no_plots", "--allow_untrained"]


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

    maps, walls = {}, {}
    for tag, extra in (("auto", []), ("torch", ["--kernel", "torch"])):
        out = OUT / f"cli_{tag}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "radar_sounder_crw_tpu_torch.cli.test_all", *CLI_ARGS, *extra,
             "--output_folder", str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        walls[tag] = time.perf_counter() - t0
        miou = [ln for ln in proc.stdout.splitlines() if ln.startswith("mIoU:")]
        # its own clock, from main's start: inference, then with the report
        elapsed = [ln.rsplit(":", 1)[1].strip() for ln in proc.stdout.splitlines()
                   if ln.startswith("Time elapsed")]
        phase("cli", f"test_all {' '.join(extra) or '(default kernel)'}: exit {proc.returncode}, "
              f"{walls[tag]:.2f} s wall, from main's start {' s / '.join(elapsed)} s "
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
    phase("cli", f"default route in process: launches {launched}, prop_seq per survey call "
          f"{per_pass} (forward, {len(per_call) - 2} correction buckets, reverse)")
    if (len(per_call) < 2 or per_pass != [1] * len(per_call)
            or launched["prop_seq"] != len(per_call) or launched["prop_step"]
            or launched["prop_all"]):
        raise SystemExit("cli.test_all --batched did not launch prop_seq once per survey call")
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
    T = session.seq.shape[0]
    want = (T - 1) + (-(-(T - 40) // 16) * 16 - 1)  # seed, then the reseed's padded tail
    phase("annotate", f"in process: seed {replies[0]['ms']} ms, reseed {replies[1]['ms']} ms, "
          f"launches {launched} (expected prop_step {want})")
    if (not all(r["ok"] for r in replies) or launched["prop_step"] != want
            or launched["prop_seq"] or launched["prop_all"]):
        raise SystemExit("cli.annotate did not launch prop_step once per frame")
    return launched, ms


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
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
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
    libs = labelprop_cuda.build(verbose=True)
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
    pipe = PropagationPipeline(model, cfg, nclasses, kernel="cuda")
    plain = PropagationPipeline(model, cfg, nclasses, kernel="torch")
    pipe(seq, seg_ref)  # warm-up: cuDNN algorithm choice, allocator

    reset_launches()
    res = pipe(seq, seg_ref, detect_change=True, return_soft=True)
    res_re = pipe.reseed(seg_ref2, reseed_frame)
    torch.cuda.synchronize()
    mc3_launches = dict(labelprop_cuda.launches)
    launches = mc3_launches["prop_step"]
    want_launches = (T - 1) + (-(-(T - reseed_frame) // 16) * 16 - 1)
    phase("seed_to_map", f"cuda path: launches {mc3_launches} (expected prop_step "
          f"{want_launches}), change_idx={res.change_idx}")
    if launches != want_launches or sum(mc3_launches.values()) != launches:
        raise SystemExit("the main path did not launch prop_step once per frame")

    ref = plain(seq, seg_ref, detect_change=True, return_soft=True)
    ref_re = plain.reseed(seg_ref2, reseed_frame)
    agree = float((res.prediction == ref.prediction).mean())
    agree_re = float((res_re.prediction == ref_re.prediction).mean())
    gt = resize_nearest(seg[: geo.rg_h(), : geo.rg_len()], (N, T))
    acc = float((res.prediction == gt).mean())
    phase("seed_to_map", f"cuda vs plain: map agreement={agree:.5f} reseed "
          f"agreement={agree_re:.5f} change_idx {res.change_idx} vs {ref.change_idx}; "
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
        "propagate_ms": wall_ms(lambda: propagate_labels(emb, seed_np, cfg, kernel="cuda")),
        "propagate_plain_ms": wall_ms(lambda: propagate_labels(emb, seed_np, cfg, kernel="torch")),
        "seed_to_map_ms": wall_ms(
            lambda: pipe(seq, seg_ref, detect_change=False, fetch_xent=False)),
        "seed_to_map_detect_ms": wall_ms(lambda: pipe(seq, seg_ref)),
        "reseed_ms": wall_ms(lambda: pipe.reseed(seg_ref2, reseed_frame)),
    }
    K, C, M, knn = 101, 128, nclasses, 20
    feats, query, mask, bias, labels = step_inputs(K, N, C, M, 60, K, 0)
    args = (feats, query, mask, bias, labels, 0.01, knn, K)
    kernel_ms = cuda_ms(lambda: labelprop_cuda.prop_step(*args), iters=50)
    plain_ms = cuda_ms(lambda: _prop_step(*args), iters=20)
    f2d = feats.reshape(K * N, C)
    matmul_ms = cuda_ms(lambda: torch.matmul(f2d, query.T), iters=50)
    ops, nbytes = step_flops_bytes(K, N, C, M, knn, K)
    bound_ms, bound_by = bound(ops, nbytes)

    # the kernel's share of one seed->map: the 99 launches of the main path,
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
            (times["propagate_ms"] - path_device_ms) / len(nslots_path) * 1e3,
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
          f"prop_all 2: seed->map, reseed); vs the cuda path: map agreement={agree_r:.5f} "
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
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in cli_times.items()))

    # 12. results ---------------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "prop_step",
        "route": "cuda",
        "source": "radar_sounder_crw_tpu_torch/csrc/prop_step.cu",
        "replaces": "radar_sounder_crw_tpu/ops/labelprop_pallas.py:466",
        "launches": launches,
        "max_abs_err": mc3_err,
        "ms": kernel_ms,
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
    }], "times": times, "survey_times": survey_times, "cli_times": cli_times}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
