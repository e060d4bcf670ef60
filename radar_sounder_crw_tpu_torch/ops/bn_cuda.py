"""The train-mode BatchNorm kernels (csrc/bn_train.cu): launches, checks and
their plain PyTorch twins.

They replace the hand-scheduled `jax.custom_vjp` of
radar_sounder_crw_tpu/models/fused_bn.py (`_bn_train`: the statistics and
normalize passes of `_bn_train_impl`, the two passes of `_bn_train_bwd`):

  * `stats(x)`: the sums (2C + 1,) float32, s1 = sum x and s2 = sum x*x
    per channel and the count n = N*H*W last;
  * `apply(x, sums, scale, bias, eps)`: (y, mean, var), y =
    ((x - mean) * inv) * scale + bias in x's dtype, mean = s1/n, var =
    s2/n - mean^2 (no clamp), inv = rsqrt(var + eps);
  * `backward_reduce(g, x, sums, eps)`: (2C,) float32, sum g and
    sum g * xhat, xhat = (x - mean) * inv recomputed from x;
  * `dx(g, x, sums, gsums, scale, eps)`: (scale * inv) * ((g - sum g / n) -
    xhat * (sum g * xhat / n)) in x's dtype.

x and g are contiguous NCHW float32 or bfloat16; everything else is
float32. Each function takes its plain twin (`*_reference`, the same
arithmetic in PyTorch ops) for CPU tensors and launches its kernel for CUDA
tensors; on the card a wrong dtype, layout or device raises, and nothing
calls `.contiguous()` or the twin. `launches[name]` counts the calls that
launch kernel `name` (the reductions' two passes count as one). The source
is built by ops/cuda_build.py with the propagation kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

cuda_build.register("bn_train")

NAMES = ("bn_stats", "bn_apply", "bn_backward_reduce", "bn_dx")
TILE = 256  # csrc/bn_train.cu: kThreads, the positions of a tile
TARGET_CTAS = 2048  # a (tile, sample chunk) grid of about this many CTAs
launches = {name: 0 for name in NAMES}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "stats": ([_P, _I] + [_I] * 5 + [_P, _P, _P], _I),
    "apply": ([_P, _I, _P, _P, _P, _F] + [_I] * 5 + [_P] * 4, _I),
    "backward_reduce": ([_P, _P, _I, _P, _F] + [_I] * 5 + [_P] * 3, _I),
    "dx": ([_P, _P, _I, _P, _P, _P, _F] + [_I] * 5 + [_P, _P], _I),
    "tile_positions": ([], _I),
    "error_string": ([_I], ctypes.c_char_p),
}
DIMS = (0, 2, 3)


def plan(N: int, C: int, HW: int) -> tuple[int, int, int]:
    """(samples a chunk, chunks, tiles) of the grid for N samples of C*HW
    positions: ceil(C*HW / TILE) tiles by as many chunks as bring the grid
    to about TARGET_CTAS. A function of the shape alone, so a shape's sums
    are always taken in the same order."""
    tiles = -(-(C * HW) // TILE)
    chunks = min(N, max(1, -(-TARGET_CTAS // tiles)))
    chunk = -(-N // chunks)
    return chunk, -(-N // chunk), tiles


_tile_checked = False


def _library() -> ctypes.CDLL:
    global _tile_checked
    lib = cuda_build.library("bn_train", SIGNATURES)
    if not _tile_checked:
        if lib.bn_train_tile_positions() != TILE:
            raise RuntimeError("csrc/bn_train.cu's tile differs from ops/bn_cuda.TILE")
        _tile_checked = True
    return lib


def _dtype_code(x: torch.Tensor) -> int:
    return {torch.float32: 0, torch.bfloat16: 1}[x.dtype]


def _check_activation(name: str, x: torch.Tensor, like: torch.Tensor | None = None) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 4-D (N, C, H, W) float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()})")
    if x.shape[0] < 1 or x.shape[1] * x.shape[2] * x.shape[3] >= 2**31:
        raise ValueError(f"{name}: need 1 or more samples of fewer than 2**31 positions, "
                         f"got {tuple(x.shape)}")
    if like is not None and (x.dtype, x.shape, x.device) != (like.dtype, like.shape, like.device):
        raise ValueError(f"{name}: need {like.dtype} {tuple(like.shape)} on {like.device} like "
                         f"x, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_vector(name: str, v: torch.Tensor, size: int, device: torch.device) -> None:
    if (v.dtype != torch.float32 or tuple(v.shape) != (size,) or not v.is_contiguous()
            or v.device != device):
        raise ValueError(f"{name}: need a contiguous float32 ({size},) tensor on {device}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _geometry(x: torch.Tensor):
    N, C, H, W = x.shape
    return N, C, H * W, plan(N, C, H * W)


def _raise_on(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.bn_train_error_string(err).decode()} "
                           f"({err})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _split(sums: torch.Tensor, C: int):
    """s1, s2 as (1, C, 1, 1) views and the count n, a 0-d tensor."""
    return sums[:C].view(1, C, 1, 1), sums[C:2 * C].view(1, C, 1, 1), sums[2 * C]


def _moments_reference(sums: torch.Tensor, C: int, eps: float):
    s1, s2, n = _split(sums, C)
    mean = s1 / n
    var = s2 / n - mean * mean
    return mean, var, torch.rsqrt(var + eps)


# -- plain twins -------------------------------------------------------------
def stats_reference(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    n = x.numel() // x.shape[1]
    return torch.cat([xf.sum(DIMS), (xf * xf).sum(DIMS), xf.new_full((1,), float(n))])


def apply_reference(x, sums, scale, bias, eps: float):
    C = x.shape[1]
    mean, var, inv = _moments_reference(sums, C, eps)
    y = (x.float() - mean) * inv * scale.view(1, C, 1, 1) + bias.view(1, C, 1, 1)
    return y.to(x.dtype), mean.reshape(C), var.reshape(C)


def backward_reduce_reference(g, x, sums, eps: float) -> torch.Tensor:
    mean, _, inv = _moments_reference(sums, x.shape[1], eps)
    gf = g.float()
    xhat = (x.float() - mean) * inv
    return torch.cat([gf.sum(DIMS), (gf * xhat).sum(DIMS)])


def dx_reference(g, x, sums, gsums, scale, eps: float) -> torch.Tensor:
    C = x.shape[1]
    mean, _, inv = _moments_reference(sums, C, eps)
    n = sums[2 * C]
    xhat = (x.float() - mean) * inv
    sg, sgx = gsums[:C].view(1, C, 1, 1), gsums[C:].view(1, C, 1, 1)
    dx = (scale.view(1, C, 1, 1) * inv) * (g.float() - sg / n - xhat * (sgx / n))
    return dx.to(x.dtype)


# -- the kernels ---------------------------------------------------------------
def stats(x: torch.Tensor) -> torch.Tensor:
    """Per-channel (sum x, sum x*x) and the count n, (2C + 1,) float32."""
    if x.device.type == "cpu":
        return stats_reference(x)
    _check_activation("x", x)
    N, C, HW, (chunk, S, tiles) = _geometry(x)
    lib = _library()
    partial = torch.empty(2 * tiles * TILE * S, dtype=torch.float32, device=x.device)
    sums = torch.empty(2 * C + 1, dtype=torch.float32, device=x.device)
    with cuda_build.on_device(x.device):
        err = lib.bn_train_stats(x.data_ptr(), _dtype_code(x), N, C, HW, chunk, S,
                                 partial.data_ptr(), sums.data_ptr(), _stream(x.device))
    _raise_on(lib, "bn_stats", err)
    launches["bn_stats"] += 1
    return sums


def apply(x, sums, scale, bias, eps: float):
    """(y in x's dtype, mean (C,), var (C,)) from the sums of `stats` (over
    this rank or all-reduced over a mesh)."""
    if x.device.type == "cpu":
        return apply_reference(x, sums, scale, bias, eps)
    _check_activation("x", x)
    N, C, HW, (chunk, S, _) = _geometry(x)
    _check_vector("sums", sums, 2 * C + 1, x.device)
    _check_vector("scale", scale, C, x.device)
    _check_vector("bias", bias, C, x.device)
    lib = _library()
    y = torch.empty_like(x)
    mean_var = torch.empty((2, C), dtype=torch.float32, device=x.device)
    with cuda_build.on_device(x.device):
        err = lib.bn_train_apply(x.data_ptr(), _dtype_code(x), sums.data_ptr(), scale.data_ptr(),
                                 bias.data_ptr(), float(eps), N, C, HW, chunk, S, y.data_ptr(),
                                 mean_var[0].data_ptr(), mean_var[1].data_ptr(),
                                 _stream(x.device))
    _raise_on(lib, "bn_apply", err)
    launches["bn_apply"] += 1
    return y, mean_var[0], mean_var[1]


def backward_reduce(g, x, sums, eps: float) -> torch.Tensor:
    """Per-channel (sum g, sum g * xhat), (2C,) float32."""
    if x.device.type == "cpu":
        return backward_reduce_reference(g, x, sums, eps)
    _check_activation("x", x)
    _check_activation("g", g, like=x)
    N, C, HW, (chunk, S, tiles) = _geometry(x)
    _check_vector("sums", sums, 2 * C + 1, x.device)
    lib = _library()
    partial = torch.empty(2 * tiles * TILE * S, dtype=torch.float32, device=x.device)
    gsums = torch.empty(2 * C, dtype=torch.float32, device=x.device)
    with cuda_build.on_device(x.device):
        err = lib.bn_train_backward_reduce(g.data_ptr(), x.data_ptr(), _dtype_code(x),
                                           sums.data_ptr(), float(eps), N, C, HW, chunk, S,
                                           partial.data_ptr(), gsums.data_ptr(),
                                           _stream(x.device))
    _raise_on(lib, "bn_backward_reduce", err)
    launches["bn_backward_reduce"] += 1
    return gsums


def dx(g, x, sums, gsums, scale, eps: float) -> torch.Tensor:
    """The input gradient in x's dtype from the forward's sums and the
    backward's (this rank's or all-reduced)."""
    if x.device.type == "cpu":
        return dx_reference(g, x, sums, gsums, scale, eps)
    _check_activation("x", x)
    _check_activation("g", g, like=x)
    N, C, HW, (chunk, S, _) = _geometry(x)
    _check_vector("sums", sums, 2 * C + 1, x.device)
    _check_vector("gsums", gsums, 2 * C, x.device)
    _check_vector("scale", scale, C, x.device)
    lib = _library()
    out = torch.empty_like(x)
    with cuda_build.on_device(x.device):
        err = lib.bn_train_dx(g.data_ptr(), x.data_ptr(), _dtype_code(x), sums.data_ptr(),
                              gsums.data_ptr(), scale.data_ptr(), float(eps), N, C, HW, chunk,
                              S, out.data_ptr(), _stream(x.device))
    _raise_on(lib, "bn_dx", err)
    launches["bn_dx"] += 1
    return out
