"""The hand-written CUDA propagation kernels: build, bind, launch.

  * `prop_step` (csrc/prop_step.cu) replaces the Pallas TPU kernel
    `_prop_step_kernel`: one frame for all N queries.
  * `prop_seq` (csrc/prop_seq.cu) replaces `_prop_seq_v2_kernel`: the
    whole (B, T-1) propagation of a batch of radargrams in one launch.
  * `prop_all` (csrc/prop_all.cu) replaces `_prop_all_kernel`: the same
    launch with the resident kernel's marking selection and weight
    arithmetic.
(all in radar_sounder_crw_tpu/ops/labelprop_pallas.py; the two
whole-sequence kernels share csrc/prop_cluster.cuh and one C interface)

Each source is compiled at first use with its own `nvcc` for sm_90a (all
sources at once) into a shared library with a plain C interface, under
`.torch_ext_build/` beside the package, and loaded with ctypes; a build
keyed by the hash of the sources and flags is reused. A failed build or
launch raises: nothing falls back to the plain version on a CUDA tensor.

On CPU tensors each wrapper runs its plain PyTorch twin
(`ops/labelprop._prop_step`, `propagate_seq_reference`,
`propagate_all_reference`); on CUDA tensors it launches the kernel.
`launches[name]` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .labelprop import _prop_step as prop_step_reference
from .labelprop import propagate_all_reference, propagate_seq_reference

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {name: CSRC / f"{name}.cu" for name in ("prop_step", "prop_seq", "prop_all")}
HEADERS = (CSRC / "prop_common.cuh", CSRC / "prop_cluster.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

launches = {name: 0 for name in SOURCES}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for c in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    blob = SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    tag = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(verbose: bool = False) -> dict[str, Path]:
    """Compile every kernel source without a library for its hash, one nvcc
    per source, all started together; returns {name: library}.
    verbose=True rebuilds all and prints ptxas's register and
    shared-memory report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in SOURCES.items():
        out = _library_path(name)
        if out.exists() and not verbose:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(f"[{name}] {err.strip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _library_path(name) for name in SOURCES}


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "prop_step":
            lib.prop_step_launch.argtypes = [p] * 7 + [i, i, i, ctypes.c_float, i, i, p]
        else:  # the whole-sequence kernels share one interface
            getattr(lib, f"{name}_launch").argtypes = (
                [p] * 5 + [i] * 7 + [ctypes.c_float] + [i] * 4 + [p])
            for fn, nargs, res in (("cluster_size", 7, i), ("smem_bytes", 5, ctypes.c_longlong),
                                   ("scratch_floats", 3, ctypes.c_longlong)):
                getattr(lib, f"{name}_{fn}").argtypes = [i] * nargs
                getattr(lib, f"{name}_{fn}").restype = res
        getattr(lib, f"{name}_launch").restype = i
        for fn in ("max_dynamic_smem", "max_classes"):
            getattr(lib, f"{name}_{fn}").argtypes = []
            getattr(lib, f"{name}_{fn}").restype = i
        getattr(lib, f"{name}_error_string").argtypes = [i]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _check(name, x, shape, device):
    if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous float32 tensor on {device}, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")


def _check_common(lib, name: str, knn: int, M: int) -> None:
    if knn < 1:
        raise ValueError(f"knn must be >= 1, got {knn}")
    if not 1 <= M <= getattr(lib, f"{name}_max_classes")():
        raise ValueError(
            f"{name}: the class count must lie in [1, {getattr(lib, f'{name}_max_classes')()}], "
            f"got {M}"
        )


def _smem_limit(lib, name: str) -> int:
    limit = getattr(lib, f"{name}_max_dynamic_smem")()
    if limit < 0:
        raise RuntimeError(f"{name}: cannot query the shared-memory limit")
    return limit


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def prop_step(feats, query, mask, slot_bias, labels, temperature: float, knn: int, nslots: int):
    """One propagation frame: feats (K, N, C), query (N, C), mask (N, N),
    slot_bias (K,), labels (K, N, M) -> pred (N, M), reading the first
    `nslots` slots. CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
    if feats.device.type == "cpu":
        return prop_step_reference(
            feats, query, mask, slot_bias, labels, temperature, knn, nslots
        )
    K, N, C = feats.shape
    M = labels.shape[-1]
    dev = feats.device
    _check("feats", feats, (K, N, C), dev)
    _check("query", query, (N, C), dev)
    _check("mask", mask, (N, N), dev)
    _check("slot_bias", slot_bias, (K,), dev)
    _check("labels", labels, (K, N, M), dev)
    lib = _library("prop_step")
    if not 1 <= nslots <= K:
        raise ValueError(f"nslots must lie in [1, {K}], got {nslots}")
    _check_common(lib, "prop_step", knn, M)
    pred = torch.empty((N, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # the affinity column lives in shared memory when it fits, else in
        # one global scratch column per query
        col_bytes = 4 * (((C + 3) & ~3) + nslots * N)
        gscratch = (
            None if col_bytes <= _smem_limit(lib, "prop_step")
            else torch.empty((N, nslots * N), dtype=torch.float32, device=dev)
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.prop_step_launch(
            feats.data_ptr(), query.data_ptr(), mask.data_ptr(),
            slot_bias.data_ptr(), labels.data_ptr(), pred.data_ptr(),
            None if gscratch is None else gscratch.data_ptr(),
            N, C, M, float(temperature), int(knn), int(nslots), stream,
        )
    _raise_on(lib, "prop_step", err)
    launches["prop_step"] += 1
    return pred


def _whole_sequence(name: str, emb, seeds, mask, long_mem: tuple, cxt: int,
                    temperature: float, knn: int):
    """One launch of the whole-sequence kernel `name` ('prop_seq' or
    'prop_all') on CUDA tensors; see `prop_seq`."""
    B, T, N, C = emb.shape
    M = seeds.shape[-1]
    dev = emb.device
    _check("emb", emb, (B, T, N, C), dev)
    _check("seeds", seeds, (B, N, M), dev)
    _check("mask", mask, (N, N), dev)
    lib = _library(name)
    _check_common(lib, name, knn, M)
    if cxt < 1:
        raise ValueError(f"cxt must be >= 1, got {cxt}")
    soft = torch.empty((B, T, N, M), dtype=torch.float32, device=dev)
    soft[:, 0] = seeds
    if T == 1 or B == 0:
        return soft
    L = len(long_mem)
    ns_max = L + min(T - 1, cxt)
    # a non-empty array, so the kernel always gets a valid pointer
    pins = torch.tensor(list(long_mem) or [0], dtype=torch.int32, device=dev)
    vec4 = int(C % 4 == 0 and emb.data_ptr() % 16 == 0)

    def fn(f, *args):
        return getattr(lib, f"{name}_{f}")(*args)

    with torch.cuda.device(dev):
        in_smem = fn("smem_bytes", C, N, ns_max, knn, 0) <= _smem_limit(lib, name)
        # CTAs per radargram (a thread-block cluster), from B, N and the card
        ncl = fn("cluster_size", B, N, C, ns_max, knn, int(not in_smem), vec4)
        if ncl < 1:
            raise RuntimeError(f"{name}: cannot size the launch's clusters")
        # the affinity columns (and prop_all's winner lists) live in shared
        # memory when they fit, else in this scratch, one area per CTA
        gscratch = (
            None if in_smem
            else torch.empty((B * ncl, fn("scratch_floats", N, ns_max, knn)),
                             dtype=torch.float32, device=dev)
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            "launch", emb.data_ptr(), mask.data_ptr(), pins.data_ptr(), soft.data_ptr(),
            None if gscratch is None else gscratch.data_ptr(),
            B, T, N, C, M, L, int(cxt), float(temperature), int(knn), ns_max, ncl, vec4,
            stream,
        )
    _raise_on(lib, name, err)
    launches[name] += 1
    return soft


def prop_seq(emb, seeds, mask, long_mem: tuple, cxt: int, temperature: float, knn: int):
    """The whole propagation of a batch of radargrams: emb (B, T, N, C)
    L2-normalized, seeds (B, N, M), mask (N, N) -> soft (B, T, N, M), frame 0
    the seeds. CPU tensors take the plain twin; CUDA tensors launch the
    kernel once (none when T == 1)."""
    if emb.device.type == "cpu":
        return propagate_seq_reference(emb, seeds, mask, long_mem, cxt, temperature, knn)
    return _whole_sequence("prop_seq", emb, seeds, mask, long_mem, cxt, temperature, knn)


def prop_all(emb, seeds, mask, long_mem: tuple, cxt: int, temperature: float, knn: int):
    """`prop_seq` with the weight arithmetic of the TPU resident kernel
    (ops/labelprop._prop_all_step_batched): same arguments and result.
    CPU tensors take the plain twin `propagate_all_reference`; CUDA tensors
    launch the kernel once (none when T == 1)."""
    if emb.device.type == "cpu":
        return propagate_all_reference(emb, seeds, mask, long_mem, cxt, temperature, knn)
    return _whole_sequence("prop_all", emb, seeds, mask, long_mem, cxt, temperature, knn)
