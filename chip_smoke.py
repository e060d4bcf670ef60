"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. build the CUDA propagation kernel from csrc/prop_step.cu (sm_90a);
  2. hold the kernel against its plain PyTorch twin at MC3 and SHARAD step
     shapes, a tie-heavy case, a valid prefix nslots < K, knn above the
     candidate count, an odd channel count and the global-scratch path:
     pred to 1e-4 absolute, argmax exactly equal;
  3. MC3 seed->map at full width (ResNet-10 float32, TF32 off) on a
     synthetic 410 x 3200 radargram, one 32x32 window with overlap (30, 0):
     T = 100 frames of N = 190 nodes, seeded from the first 32 columns,
     change detection on, then one reseed at frame 40; the CUDA kernel path
     against the plain path: >= 99.5 % equal maps, equal change_idx;
  4. times on the card: encode, propagate, seed->map and reseed wall ms,
     the kernel per launch and per seed->map, the plain step, and one
     torch.matmul of the same affinity product as a yardstick;
  5. a JSON line describing each kernel, the card's name and power limit,
     and the final {"ok": true, ...} line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
STEP_ATOL = 1e-4  # pred is a convex mix of labels in [0, 1]: summation order only
MAP_AGREEMENT = 0.995


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


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
    lib_path = labelprop_cuda.build(verbose=True)
    phase("build", f"ok {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    # 2. kernel vs plain at step shapes ---------------------------------------
    cases = [
        # name, K, N, C, M, knn, radius, temperature, nslots, ties
        ("mc3", 101, 190, 128, 6, 20, 60, 0.01, 101, False),
        ("mc3_prefix", 101, 190, 128, 6, 20, 60, 0.01, 37, False),
        ("sharad", 101, 113, 128, 5, 20, 10, 0.1, 101, False),
        ("sharad_ties", 101, 113, 128, 5, 20, 10, 0.1, 64, True),
        ("knn_over_candidates", 4, 5, 8, 3, 30, 3, 0.07, 2, False),
        ("odd_channels", 7, 30, 7, 4, 9, 5, 0.07, 7, False),
        ("global_scratch", 160, 400, 64, 4, 20, 30, 0.05, 160, False),
    ]
    mc3_err = 0.0
    for i, (name, K, N, C, M, knn, radius, temp, nslots, ties) in enumerate(cases):
        feats, query, mask, bias, labels = step_inputs(K, N, C, M, radius, nslots, i, ties)
        got = labelprop_cuda.prop_step(feats, query, mask, bias, labels, temp, knn, nslots)
        want = _prop_step(feats, query, mask, bias, labels, temp, knn, nslots)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same_argmax = torch.equal(got.argmax(-1), want.argmax(-1))
        phase("kernel_vs_plain", f"{name} K={K} N={N} C={C} M={M} knn={knn} "
              f"nslots={nslots}: max_abs_err={err:.3e} argmax_equal={same_argmax}")
        if not (torch.isfinite(got).all() and err <= STEP_ATOL and same_argmax):
            raise SystemExit(f"kernel disagrees with the plain step on {name}")
        if name.startswith("mc3"):
            mc3_err = max(mc3_err, err)

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

    labelprop_cuda.launches["prop_step"] = 0
    res = pipe(seq, seg_ref, detect_change=True, return_soft=True)
    res_re = pipe.reseed(seg_ref2, reseed_frame)
    torch.cuda.synchronize()
    launches = labelprop_cuda.launches["prop_step"]
    want_launches = (T - 1) + (-(-(T - reseed_frame) // 16) * 16 - 1)
    phase("seed_to_map", f"cuda path: prop_step launches={launches} "
          f"(expected {want_launches}), change_idx={res.change_idx}")
    if launches != want_launches:
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
    bound_ms = max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"

    # the kernel's share of one seed->map: the 99 launches of the main path,
    # each over its valid prefix of 1 + min(t, 100) slots
    nslots_path = [1 + min(t, 100) for t in range(1, T)]

    def path_launches():
        for ns in nslots_path:
            labelprop_cuda.prop_step(feats, query, mask, bias, labels, 0.01, knn, ns)

    path_kernel_ms = cuda_ms(path_launches, iters=3, warmup=1)
    path_ops = sum(step_flops_bytes(K, N, C, M, knn, ns)[0] for ns in nslots_path)
    path_bound_ms = path_ops / PEAK_F32_FLOPS * 1e3
    times.update({
        "kernel_ms_per_launch": kernel_ms,
        "kernel_us_per_frame_on_path": path_kernel_ms / len(nslots_path) * 1e3,
        "kernel_ms_per_seed_to_map": path_kernel_ms,
        "kernel_bound_ms_per_seed_to_map": path_bound_ms,
        "plain_step_ms": plain_ms,
        "affinity_matmul_ms": matmul_ms,
    })
    phase("times", f"{smi} | " + " ".join(f"{k}={v:.4f}" for k, v in times.items())
          + f" | path GFLOP={path_ops / 1e9:.2f}")

    # 5. results ----------------------------------------------------------------
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
    }], "times": times}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
