"""The hand-written CUDA propagation step (csrc/prop_step.cu): build, bind,
launch.

Replaces the Pallas TPU kernel `_prop_step_kernel`
(radar_sounder_crw_tpu/ops/labelprop_pallas.py). The source is compiled at
first use with `nvcc` for sm_90a into a shared library with a plain C
interface, under `.torch_ext_build/` beside the package, and loaded with
ctypes; a build keyed by the source's hash is reused. A failed build or
launch raises: nothing falls back to the plain step on a CUDA tensor.

`prop_step` on CPU tensors runs the plain PyTorch twin
(`ops/labelprop._prop_step`); on CUDA tensors it launches the kernel.
`launches["prop_step"]` counts the kernel's launches.
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

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "prop_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

launches = {"prop_step": 0}
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for c in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> Path:
    """Compile csrc/prop_step.cu (once per source hash); returns the library.
    verbose=True prints ptxas's register and shared-memory report."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libprop_step_{tag}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prop_step_launch.argtypes = [p] * 7 + [i, i, i, ctypes.c_float, i, i, p]
        lib.prop_step_launch.restype = i
        lib.prop_step_max_dynamic_smem.argtypes = []
        lib.prop_step_max_dynamic_smem.restype = i
        lib.prop_step_max_knn.argtypes = []
        lib.prop_step_max_knn.restype = i
        lib.prop_step_error_string.argtypes = [i]
        lib.prop_step_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, x, shape, device):
    if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous float32 tensor on {device}, got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})"
        )
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")


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
    lib = _library()
    if not 1 <= nslots <= K:
        raise ValueError(f"nslots must lie in [1, {K}], got {nslots}")
    if not 1 <= knn <= lib.prop_step_max_knn():
        raise ValueError(f"knn must lie in [1, {lib.prop_step_max_knn()}], got {knn}")
    pred = torch.empty((N, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # the affinity column lives in shared memory when it fits, else in
        # one global scratch column per query
        limit = lib.prop_step_max_dynamic_smem()
        if limit < 0:
            raise RuntimeError("prop_step: cannot query the shared-memory limit")
        col_bytes = 4 * (((C + 3) & ~3) + nslots * N)
        gscratch = (
            None if col_bytes <= limit
            else torch.empty((N, nslots * N), dtype=torch.float32, device=dev)
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.prop_step_launch(
            feats.data_ptr(), query.data_ptr(), mask.data_ptr(),
            slot_bias.data_ptr(), labels.data_ptr(), pred.data_ptr(),
            None if gscratch is None else gscratch.data_ptr(),
            N, C, M, float(temperature), int(knn), int(nslots), stream,
        )
    if err != 0:
        msg = lib.prop_step_error_string(err).decode()
        raise RuntimeError(f"prop_step launch failed: {msg} ({err})")
    launches["prop_step"] += 1
    return pred
