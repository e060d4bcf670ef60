"""The port's one build of its hand-written CUDA sources.

Every kernel module registers its source here at import (`register`): the
propagation kernels of `ops/labelprop_cuda.py` and the train-mode BatchNorm
kernels of `ops/bn_cuda.py`. `build()` compiles each registered source
without a library for its hash with its own `nvcc` for sm_90a, all started
together, into a shared library with a plain C interface under
`.torch_ext_build/` beside the package; the library is keyed by the hash of
the source, its headers and the flags, and reused while they are unchanged.
`library(name, signatures)` builds at first use and loads the library with
ctypes. A failed build raises and names the source: nothing falls back to
a plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

SOURCES: dict[str, Path] = {}  # name -> csrc/<name>.cu
_headers: dict[str, tuple[Path, ...]] = {}
_libs: dict[str, ctypes.CDLL] = {}


def register(name: str, headers: tuple[str, ...] = ()) -> None:
    """Make `csrc/<name>.cu`, which includes `headers` (names under csrc/),
    one of the sources `build()` compiles."""
    SOURCES[name] = CSRC / f"{name}.cu"
    _headers[name] = tuple(CSRC / h for h in headers)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for c in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    blob = SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in _headers[name])
    tag = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(verbose: bool = False) -> dict[str, Path]:
    """Compile every registered source without a library for its hash, one
    nvcc per source, all started together; returns {name: library}.
    verbose=True rebuilds all and prints ptxas's register and shared-memory
    report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in SOURCES.items():
        out = library_path(name)
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
            failed.append(f"{name}: nvcc failed on {SOURCES[name]} ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(f"[{name}] {err.strip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in SOURCES}


def library(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library of source `name` (built at first use), its
    functions `{name}_{fn}` typed from `signatures` {fn: (argtypes,
    restype)}."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        for fn, (args, res) in signatures.items():
            getattr(lib, f"{name}_{fn}").argtypes = args
            getattr(lib, f"{name}_{fn}").restype = res
        _libs[name] = lib
    return _libs[name]


def on_device(device: torch.device):
    """The context that makes `device` current, entered only when it is not
    (entering one costs microseconds on every launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
