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
launch kernel `name` (each is one launch, in whichever vector variant its
plan takes). `tile_plan` sizes the grids of the tiled kernels (stats,
apply, backward_reduce) and `backward_plan` that of dx: pure functions of
the shape (and for the tiled kernels the dtype, the SM count and the
activations' alignment), so the CPU tests reach them. The source is built
by ops/cuda_build.py with the propagation kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import cuda_build

cuda_build.register("bn_train")

NAMES = ("bn_stats", "bn_apply", "bn_backward_reduce", "bn_dx")
# csrc/bn_train.cu's constants, checked against the library at first use
THREADS = 256  # kThreads: threads of a CTA; positions of a dx tile
CTAS_PER_SM = 4  # kCtasPerSm: stats' and apply's residency, CTAs an SM in one wave
# kReduceCtasPerSm: the grid of a reduction (stats, backward_reduce), CTAs an SM in one
# wave, few so that its last CTAs sum few partials
REDUCE_CTAS_PER_SM = 2
APPLY_VECTORS = 8  # vectors an apply thread walks at least, to hide its CTA's start-up
MAX_SLOTS = 128  # kMaxSlots: channel slots of a tile
ROW_BYTES = 128  # the least of a sample's row a tile reads: one cache line
TARGET_CTAS = 2048  # dx's (tile, sample chunk) grid: about this many CTAs
TILED = ("stats", "apply", "backward_reduce")  # the kernels `tile_plan` plans
launches = {name: 0 for name in NAMES}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "stats": ([_P, _I] + [_I] * 12 + [_P] * 4, _I),
    "apply": ([_P, _I, _P, _P, _P, _F] + [_I] * 12 + [_P] * 4, _I),
    "backward_reduce": ([_P, _P, _I, _P, _F] + [_I] * 12 + [_P] * 4, _I),
    "dx": ([_P, _P, _I, _P, _P, _P, _F] + [_I] * 5 + [_P, _P], _I),
    "constant": ([_I], _I),
    "error_string": ([_I], ctypes.c_char_p),
}
DIMS = (0, 2, 3)


class TilePlan(NamedTuple):
    """The grid of a tiled kernel (`stats`, `apply`, `backward_reduce` of
    csrc/bn_train.cu): `tiles` x `chunks` CTAs of `threads` threads. A CTA
    covers `tile` vectors of `vector` elements of a sample's C*HW plane,
    `rows` samples at a time, over a chunk of `chunk` samples; a
    reduction's partial sums take `slots` channel slots, and the last CTA of
    each group of `group` tiles sums them."""

    vector: int
    tile: int
    rows: int
    threads: int
    tiles: int
    chunk: int
    chunks: int
    slots: int
    group: int

    @property
    def groups(self) -> int:
        """Ticket counters a reduction uses."""
        return -(-self.tiles // self.group)

    @property
    def scratch(self) -> int:
        """float32 partials of a reduction (stats, backward_reduce): two sums
        a (tile, chunk, channel slot)."""
        return 2 * self.tiles * self.chunks * self.slots


@functools.lru_cache(maxsize=512)
def tile_plan(N: int, C: int, HW: int, itemsize: int, sms: int, align: int = 16,
              kernel: str = "stats") -> TilePlan:
    """The grid of tiled kernel `kernel` (one of TILED) for N samples of C
    channels of HW positions, `itemsize` bytes an element (4 float32, 2
    bfloat16), on a card of `sms` SMs, every activation it reads or writes
    at a multiple of `align` bytes. A pure function of these, so a shape's
    sums are always taken in one order.

    * vector: the most elements, up to 16 bytes, that divide the plane and
      the alignment;
    * tile: whole channels where a CTA's row holds them (the fewest whole
      channels that fill whole vectors, repeated to reach ROW_BYTES, and for
      apply, whose partly written sectors cost a read, further to a whole
      number of 32-byte sectors where that takes at most THREADS / 2
      vectors), one ticket a tile; else THREADS vectors, channels across
      tiles, one ticket for the grid;
    * rows: as many samples as fill THREADS threads;
    * chunks: for the reductions (stats, backward_reduce)
      REDUCE_CTAS_PER_SM CTAs an SM, for apply the whole waves of
      CTAS_PER_SM CTAs an SM nearest APPLY_VECTORS vectors a thread; never
      more than the samples allow."""
    if kernel not in TILED:
        raise ValueError(f"tile_plan: kernel {kernel!r} is not one of {TILED}")
    P = C * HW
    vector = 16 // itemsize
    while vector > 1 and (P % vector or align % (vector * itemsize)):
        vector //= 2
    vp = P // vector
    unit = vector // math.gcd(HW, vector) * HW // vector  # whole channels, whole vectors
    if unit <= THREADS:
        k = -(-ROW_BYTES // (vector * itemsize * unit))
        if kernel == "apply":  # y's rows in whole 32-byte sectors, where half a CTA holds them
            k = next((j for j in range(k, THREADS // (2 * unit) + 1)
                      if unit * j * vector * itemsize % 32 == 0), k)
        tile = min(vp, unit * min(k, THREADS // unit))
    else:
        tile = THREADS
    tiles = -(-vp // tile)
    positions = tile * vector
    whole = tiles == 1 or positions % HW == 0
    if tiles == 1:
        slots = C
    elif whole:
        slots = positions // HW
    else:
        slots = min(C, (positions + HW - 2) // HW + 1)
    rows = THREADS // tile
    if kernel == "apply":
        wave = CTAS_PER_SM * sms
        ctas = wave * max(1, round(tiles * -(-N // (APPLY_VECTORS * rows)) / wave))
    else:
        ctas = REDUCE_CTAS_PER_SM * sms
    chunks = max(1, min(ctas // tiles, -(-N // rows)))
    chunk = -(-N // chunks)
    return TilePlan(vector=vector, tile=tile, rows=rows, threads=-(-tile * rows // 32) * 32,
                    tiles=tiles, chunk=chunk, chunks=-(-N // chunk), slots=slots,
                    group=1 if whole else tiles)


def backward_plan(N: int, C: int, HW: int) -> tuple[int, int, int]:
    """(samples a chunk, chunks, tiles) of the dx kernel's grid for N
    samples of C*HW positions: ceil(C*HW / THREADS) tiles by as many chunks
    as bring the grid to about TARGET_CTAS. A function of the shape alone."""
    tiles = -(-(C * HW) // THREADS)
    chunks = min(N, max(1, -(-TARGET_CTAS // tiles)))
    chunk = -(-N // chunks)
    return chunk, -(-N // chunk), tiles


_constants_checked = False
_sms: dict[int, int] = {}
_tickets: dict[int, list[torch.Tensor]] = {}


def _library() -> ctypes.CDLL:
    global _constants_checked
    lib = cuda_build.library("bn_train", SIGNATURES)
    if not _constants_checked:
        got = tuple(lib.bn_train_constant(i) for i in range(4))
        if got != (THREADS, CTAS_PER_SM, MAX_SLOTS, REDUCE_CTAS_PER_SM):
            raise RuntimeError(f"csrc/bn_train.cu's (kThreads, kCtasPerSm, kMaxSlots, "
                               f"kReduceCtasPerSm) = {got} differ from ops/bn_cuda's")
        _constants_checked = True
    return lib


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every tensor's
    address: the alignment `tile_plan` takes for a kernel that reads them
    all (backward_reduce reads g, whose address autograd chooses, beside
    x)."""
    return min([16] + [t.data_ptr() & -t.data_ptr() for t in tensors])


def _plan_of(kernel: str, x: torch.Tensor, *others: torch.Tensor) -> TilePlan:
    N, C, H, W = x.shape
    index = _index(x.device)
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return tile_plan(N, C, H * W, x.element_size(), _sms[index], alignment(x, *others), kernel)


def _ticket_counters(device: torch.device, groups: int) -> torch.Tensor:
    """Zeroed int32 counters of `device`, at least `groups` of them; a
    stats or backward_reduce launch leaves them zero. Kept for the
    process's life: a captured CUDA graph holds their address. Both
    reductions' calls on one device share them, so they run in one stream's
    order (as every kernel of the port does: a training step, eager or
    captured in a graph, launches on one stream)."""
    held = _tickets.setdefault(_index(device), [])
    if not held or held[-1].numel() < groups:
        held.append(torch.zeros(max(groups, 4096), dtype=torch.int32, device=device))
    return held[-1]


def reduce_buffers(pl: TilePlan, outputs: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A reduction's scratch (its partials, `pl.scratch` floats) and its
    output (`outputs` floats: 2C + 1 for stats, 2C for backward_reduce),
    uninitialised."""
    return (torch.empty(pl.scratch, dtype=torch.float32, device=device),
            torch.empty(outputs, dtype=torch.float32, device=device))


def _tile_args(N: int, C: int, HW: int, pl: TilePlan) -> tuple[int, ...]:
    return (N, C, HW, pl.vector, pl.tile, pl.rows, pl.threads, pl.tiles, pl.chunk, pl.chunks,
            pl.slots, pl.group)


def _dtype_code(x: torch.Tensor) -> int:
    return {torch.float32: 0, torch.bfloat16: 1}[x.dtype]


def _check_activation(name: str, x: torch.Tensor, like: torch.Tensor | None = None) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 4-D (N, C, H, W) float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)} (contiguous="
                         f"{x.is_contiguous()})")
    if x.shape[0] < 1 or not 1 <= x.shape[1] * x.shape[2] * x.shape[3] < 2**31:
        raise ValueError(f"{name}: need 1 or more samples of 1 to 2**31 - 1 positions, "
                         f"got {tuple(x.shape)}")
    if like is not None and (x.dtype, x.shape, x.device) != (like.dtype, like.shape, like.device):
        raise ValueError(f"{name}: need {like.dtype} {tuple(like.shape)} on {like.device} like "
                         f"x, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_vector(name: str, v: torch.Tensor, size: int, device: torch.device) -> None:
    if (v.dtype != torch.float32 or tuple(v.shape) != (size,) or not v.is_contiguous()
            or v.device != device):
        raise ValueError(f"{name}: need a contiguous float32 ({size},) tensor on {device}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")


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
    N, C, H, W = x.shape
    pl = _plan_of("stats", x)
    lib = _library()
    partial, sums = reduce_buffers(pl, 2 * C + 1, x.device)
    tickets = _ticket_counters(x.device, pl.groups)
    with cuda_build.on_device(x.device):
        err = lib.bn_train_stats(x.data_ptr(), _dtype_code(x), *_tile_args(N, C, H * W, pl),
                                 partial.data_ptr(), tickets.data_ptr(), sums.data_ptr(),
                                 _stream(x.device))
    _raise_on(lib, "bn_stats", err)
    launches["bn_stats"] += 1
    return sums


def apply(x, sums, scale, bias, eps: float):
    """(y in x's dtype, mean (C,), var (C,)) from the sums of `stats` (over
    this rank or all-reduced over a mesh)."""
    if x.device.type == "cpu":
        return apply_reference(x, sums, scale, bias, eps)
    _check_activation("x", x)
    N, C, H, W = x.shape
    _check_vector("sums", sums, 2 * C + 1, x.device)
    _check_vector("scale", scale, C, x.device)
    _check_vector("bias", bias, C, x.device)
    pl = _plan_of("apply", x)
    lib = _library()
    y = torch.empty_like(x)
    mean_var = torch.empty((2, C), dtype=torch.float32, device=x.device)
    with cuda_build.on_device(x.device):
        err = lib.bn_train_apply(x.data_ptr(), _dtype_code(x), sums.data_ptr(), scale.data_ptr(),
                                 bias.data_ptr(), float(eps), *_tile_args(N, C, H * W, pl),
                                 y.data_ptr(), mean_var[0].data_ptr(), mean_var[1].data_ptr(),
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
    N, C, H, W = x.shape
    _check_vector("sums", sums, 2 * C + 1, x.device)
    pl = _plan_of("backward_reduce", x, g)
    lib = _library()
    partial, gsums = reduce_buffers(pl, 2 * C, x.device)
    tickets = _ticket_counters(x.device, pl.groups)
    with cuda_build.on_device(x.device):
        err = lib.bn_train_backward_reduce(g.data_ptr(), x.data_ptr(), _dtype_code(x),
                                           sums.data_ptr(), float(eps),
                                           *_tile_args(N, C, H * W, pl), partial.data_ptr(),
                                           tickets.data_ptr(), gsums.data_ptr(),
                                           _stream(x.device))
    _raise_on(lib, "bn_backward_reduce", err)
    launches["bn_backward_reduce"] += 1
    return gsums


def dx(g, x, sums, gsums, scale, eps: float) -> torch.Tensor:
    """The input gradient in x's dtype from the forward's sums and the
    backward's (this rank's or all-reduced), on `backward_plan`'s grid."""
    if x.device.type == "cpu":
        return dx_reference(g, x, sums, gsums, scale, eps)
    _check_activation("x", x)
    _check_activation("g", g, like=x)
    N, C, H, W = x.shape
    HW = H * W
    chunk, S, _ = backward_plan(N, C, HW)
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
