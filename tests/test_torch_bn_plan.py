"""The tiled BatchNorm kernels' plan (radar_sounder_crw_tpu_torch/ops/
bn_cuda.py `tile_plan`, the grid of `stats`, `apply` and
`backward_reduce` in csrc/bn_train.cu) on the CPU, and the kernels' plain
twins against the JAX package's `_bn_train_impl` and `_bn_train_bwd`.

The plan at the 13 BatchNorm shapes of the bench step (N = 18,080 patches)
and at the card tests' edge shapes, float32 and bfloat16, each kernel, on
a card of 132 SMs (and others):
  * the kernels' threads, as csrc/bn_train.cu maps them, visit every
    element (of x, and of g for backward_reduce) exactly once;
  * the plan is a function of (shape, dtype, SM count, alignment) alone;
  * the vector is the widest (up to 16 bytes) that divides a sample's plane
    and the alignment: bfloat16 (., 3, 18, 18) takes 4 elements; the
    wrapper's alignment is the smaller of g's and x's addresses';
  * a reduction's partials (stats, backward_reduce) lie inside the scratch
    the wrapper allocates, each (tile, chunk, channel slot) once, and a
    ticket a tile only where tiles hold whole channels.

Twins: `stats_reference` then `apply_reference` against `_bn_train_impl`
on the same numpy input, NHWC on the JAX side, as tests/test_torch_fused_bn.py
holds the modules: mean and var within rtol 2e-5 / atol 2e-5 (float32 sums
of up to 15,552 elements a channel, in XLA's order and PyTorch's), y within
the same in float32 and within one bfloat16 rounding (rtol 2**-7) in
bfloat16. `backward_reduce_reference` then `dx_reference` against
`_bn_train_bwd` given the same sums: the sums within 2e-5 of the sums of
magnitudes (float32 summation order), dx as y.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.models.fused_bn import _bn_train_bwd, _bn_train_impl
from radar_sounder_crw_tpu_torch.ops import bn_cuda

PATCHES = 18080
BENCH_SHAPES = [(PATCHES, *s) for s in (
    (3, 18, 18), (64, 9, 9), (64, 5, 5), (64, 5, 5), (128, 3, 3), (128, 3, 3), (128, 3, 3),
    (256, 2, 2), (256, 2, 2), (256, 2, 2), (512, 1, 1), (512, 1, 1), (512, 1, 1))]
EDGE_SHAPES = [
    (48, 3, 18, 18), (32, 64, 9, 9), (96, 64, 5, 5), (40, 512, 1, 1), (7, 5, 3, 3),
    (33, 3, 18, 18), (1, 64, 5, 5), (5, 3, 5, 5), (4, 3, 64, 64), (3, 2, 17, 17),
]
SHAPES = sorted(set(BENCH_SHAPES)) + EDGE_SHAPES
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _visits(pl, N, C, HW):
    """(visits of each sample, visits of each plane position, per tile the
    active threads' (tx, ty) set) as the kernels' threads make them:
    thread tid of CTA (tile t, chunk s) is (tx, ty) = (tid % tile, tid //
    tile), active where ty < rows and its vector lies in the tile, and
    walks samples s*chunk + ty, + rows, ... below min(N, (s+1)*chunk) at
    positions (t*tile + tx)*vector + k, k < vector."""
    vp = C * HW // pl.vector
    samples = np.zeros(N, np.int64)
    for s in range(pl.chunks):
        for ty in range(pl.rows):
            samples[s * pl.chunk + ty:min(N, (s + 1) * pl.chunk):pl.rows] += 1
    positions = np.zeros(C * HW, np.int64)
    active = []
    for t in range(pl.tiles):
        npos = min(pl.tile, vp - t * pl.tile) * pl.vector
        tid = np.arange(pl.threads)
        tx, ty = tid % pl.tile, tid // pl.tile
        on = (ty < pl.rows) & (tx * pl.vector < npos)
        active.append(set(zip(tx[on].tolist(), ty[on].tolist())))
        for x in np.unique(tx[on]):
            p0 = (t * pl.tile + x) * pl.vector
            positions[p0:p0 + pl.vector] += 1
    return samples, positions, active


def _tile_channels(pl, C, HW, t):
    """(first channel, channels) of tile t, as csrc/bn_train.cu tile_span."""
    vp = C * HW // pl.vector
    pos0 = t * pl.tile * pl.vector
    npos = min(pl.tile, vp - t * pl.tile) * pl.vector
    c_lo = pos0 // HW
    return c_lo, (pos0 + npos - 1) // HW - c_lo + 1


@pytest.mark.parametrize("kernel", bn_cuda.TILED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_element_once(shape, dtype, kernel):
    N, C, H, W = shape
    HW = H * W
    pl = bn_cuda.tile_plan(N, C, HW, ITEMSIZE[dtype], 132, kernel=kernel)
    samples, positions, active = _visits(pl, N, C, HW)
    assert (samples == 1).all() and (positions == 1).all()
    vp = C * HW // pl.vector
    for t, pairs in enumerate(active):  # every (column, row) of the tile, so visits multiply
        width = min(pl.tile, vp - t * pl.tile)
        assert pairs == {(x, y) for x in range(width) for y in range(pl.rows)}
    assert pl.threads % 32 == 0 and pl.tile * pl.rows <= pl.threads <= bn_cuda.THREADS
    # whole waves of resident CTAs (the reductions: half a wave of stats')
    # but for the rounding of the chunks, unless the samples run out
    wave = (bn_cuda.CTAS_PER_SM if kernel == "apply" else bn_cuda.REDUCE_CTAS_PER_SM) * 132
    ctas, waves = pl.tiles * pl.chunks, -(-pl.tiles * pl.chunks // wave)
    assert ctas >= 0.95 * waves * wave or pl.chunks == -(-N // pl.rows)
    assert kernel == "apply" or waves == 1 or pl.chunks == 1


@pytest.mark.parametrize("kernel", bn_cuda.TILED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_is_a_function_of_shape_and_card(shape, dtype, kernel):
    N, C, H, W = shape
    plan = bn_cuda.tile_plan.__wrapped__
    plans = {}
    for sms in (132, 114, 8):
        plans[sms] = plan(N, C, H * W, ITEMSIZE[dtype], sms, kernel=kernel)
        assert plan(N, C, H * W, ITEMSIZE[dtype], sms, kernel=kernel) == plans[sms]
        assert bn_cuda.tile_plan(N, C, H * W, ITEMSIZE[dtype], sms, kernel=kernel) == plans[sms]
    # the SM count moves the chunks alone
    for other in (plans[114], plans[8]):
        assert other[:5] == plans[132][:5] and other[7:] == plans[132][7:]


@pytest.mark.parametrize("kernel", bn_cuda.TILED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_vector_follows_the_alignment_rule(shape, dtype, kernel):
    N, C, H, W = shape
    P, size = C * H * W, ITEMSIZE[dtype]
    for align in (16, 8, 4, 2):
        v = bn_cuda.tile_plan(N, C, H * W, size, 132, align, kernel).vector
        want = max(w for w in (1, 2, 4, 8, 16) if w * size <= 16 and P % w == 0
                   and (w == 1 or align % (w * size) == 0))
        assert v == want, align


def test_bf16_first_batchnorm_takes_the_unaligned_variant():
    """bfloat16 at (C, H, W) = (3, 18, 18): 972 elements, 1944 bytes a
    sample, not a multiple of 16: 4-element (8-byte) vectors; every other
    bench shape, and float32 everywhere, 16 bytes."""
    for shape in sorted(set(BENCH_SHAPES)):
        N, C, H, W = shape
        bf16 = bn_cuda.tile_plan(N, C, H * W, 2, 132).vector
        assert bf16 == (4 if (C, H, W) == (3, 18, 18) else 8)
        assert bn_cuda.tile_plan(N, C, H * W, 4, 132).vector == 4
    assert bn_cuda.tile_plan(PATCHES, 3, 324, 2, 132, align=8).vector == 4
    assert bn_cuda.tile_plan(PATCHES, 64, 81, 2, 132, align=8).vector == 4


@pytest.mark.parametrize("offsets", [(0, 0), (0, 1), (1, 0), (2, 0), (0, 4), (3, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_vector_follows_the_smaller_alignment(dtype, offsets):
    """`alignment(x, g)`, which the backward_reduce wrapper plans with, is
    that of the less aligned address: g a view at an offset of one element
    from a 64-byte-aligned allocation, as an autograd gradient may be,
    narrows the vector for both inputs (a bfloat16 element: 2 bytes, scalar
    loads)."""
    N, C, H, W = 4, 64, 5, 5
    size = torch.finfo(dtype).bits // 8
    views = []
    for off in offsets:
        base = torch.zeros(N * C * H * W + 8, dtype=dtype)
        assert base.data_ptr() % 64 == 0
        views.append(base[off:off + N * C * H * W].view(N, C, H, W))
    x, g = views
    want = min([16] + [off * size & -(off * size) for off in offsets if off])
    assert bn_cuda.alignment(x, g) == bn_cuda.alignment(g, x) == want
    pl = bn_cuda.tile_plan(N, C, H * W, size, 132, bn_cuda.alignment(x, g), "backward_reduce")
    assert pl.vector == want // size


@pytest.mark.parametrize("kernel", ["stats", "backward_reduce"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_partials_fit_the_scratch_the_wrapper_allocates(shape, dtype, kernel):
    N, C, H, W = shape
    HW = H * W
    pl = bn_cuda.tile_plan(N, C, HW, ITEMSIZE[dtype], 132, kernel=kernel)
    outputs = 2 * C + 1 if kernel == "stats" else 2 * C
    partial, out = bn_cuda.reduce_buffers(pl, outputs, "cpu")
    assert partial.numel() == pl.scratch and out.numel() == outputs
    written = np.zeros(pl.scratch, np.int64)
    tiles_of = [[] for _ in range(C)]
    for t in range(pl.tiles):
        c_lo, nslots = _tile_channels(pl, C, HW, t)
        assert 1 <= nslots <= pl.slots <= bn_cuda.MAX_SLOTS
        for c in range(c_lo, c_lo + nslots):
            tiles_of[c].append(t)
        for q in range(2):
            for s in range(pl.chunks):
                at = ((q * pl.tiles + t) * pl.chunks + s) * pl.slots
                written[at:at + nslots] += 1
    assert written.max() == 1
    if pl.group == 1:  # a ticket a tile: no channel across two tiles
        assert all(len(ts) == 1 for ts in tiles_of)
    else:
        assert pl.group == pl.tiles and pl.groups == 1
    assert pl.groups == -(-pl.tiles // pl.group)


def test_bench_plans_hold_whole_channels_in_whole_waves():
    """At the bench shapes every tile holds whole channels (a ticket a tile)
    and reads at least a 128-byte line of a row; the stats and
    backward_reduce grids are 2 CTAs on each of 132 SMs, give or take the
    tiles' remainder, on the same tiles, and apply's whole waves of 4 give
    each thread 8 to 10 vectors to walk."""
    for shape in sorted(set(BENCH_SHAPES)):
        N, C, H, W = shape
        for size in (2, 4):
            pl = bn_cuda.tile_plan(N, C, H * W, size, 132)
            assert pl.group == 1
            assert 256 <= pl.tiles * pl.chunks <= 264
            assert pl.tile * pl.vector * size >= bn_cuda.ROW_BYTES
            pr = bn_cuda.tile_plan(N, C, H * W, size, 132, kernel="backward_reduce")
            assert pr.group == 1 and pr[:5] == pl[:5] and pr.slots == pl.slots
            assert 256 <= pr.tiles * pr.chunks <= 264
            pa = bn_cuda.tile_plan(N, C, H * W, size, 132, kernel="apply")
            ctas = pa.tiles * pa.chunks
            assert ctas >= 0.95 * 528 * -(-ctas // 528)
            # y's row segments in whole 32-byte sectors, but where a CTA's
            # 256 threads would hold one row of them (bn0, the stem)
            assert (pa.tile * pa.vector * size % 32 == 0) != ((C, H, W) in ((3, 18, 18),
                                                                            (64, 9, 9)))
            assert 7.5 <= pa.chunk / pa.rows <= 10


def _jax_forward(x_nchw, scale, bias, eps, jdtype):
    y, mean, var, _ = _bn_train_impl(jnp.asarray(np.transpose(x_nchw, (0, 2, 3, 1))).astype(jdtype),
                                     jnp.asarray(scale), jnp.asarray(bias), eps)
    y = np.transpose(np.asarray(y.astype(jnp.float32)), (0, 3, 1, 2))
    return y, np.asarray(mean), np.asarray(var)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 3, 18, 18), (33, 3, 18, 18), (16, 64, 5, 5),
                                   (40, 512, 1, 1), (7, 5, 3, 3), (1, 64, 5, 5)])
def test_twins_match_jax_bn_train_impl(shape, dtype):
    rng = np.random.default_rng(3)
    C = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(C) + 1.0).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want_y, want_mean, want_var = _jax_forward(x, scale, bias, 1e-5, jdtype)
    xt = torch.as_tensor(x).to(tdtype)
    sums = bn_cuda.stats(xt)  # the CPU tensor takes the twin
    assert sums.shape == (2 * C + 1,) and sums[-1].item() == x.size // C
    y, mean, var = bn_cuda.apply(xt, sums, torch.as_tensor(scale), torch.as_tensor(bias), 1e-5)
    assert y.dtype == tdtype
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=2e-5, atol=2e-5)
    rtol = 2e-5 if dtype == "float32" else 2**-7
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=rtol, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 3, 18, 18), (33, 3, 18, 18), (16, 64, 5, 5),
                                   (40, 512, 1, 1), (7, 5, 3, 3), (1, 64, 5, 5)])
def test_backward_twins_match_jax_bn_train_bwd(shape, dtype):
    rng = np.random.default_rng(4)
    C = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(C) + 1.0).astype(np.float32)
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    xt, gt = torch.as_tensor(x).to(tdtype), torch.as_tensor(g).to(tdtype)
    sums = bn_cuda.stats(xt)
    mean, _, inv = bn_cuda._moments_reference(sums, C, 1e-5)
    nhwc = (0, 2, 3, 1)
    xj = jnp.asarray(np.transpose(xt.float().numpy(), nhwc)).astype(jdtype)
    gj = jnp.asarray(np.transpose(gt.float().numpy(), nhwc)).astype(jdtype)
    res = (xj, jnp.asarray(scale), jnp.asarray(mean.reshape(C).numpy()),
           jnp.asarray(inv.reshape(C).numpy()))
    want_dx, want_dscale, want_dbias = _bn_train_bwd(1e-5, res, (gj, None, None))
    gsums = bn_cuda.backward_reduce(gt, xt, sums, 1e-5)  # the CPU tensors take the twin
    assert gsums.shape == (2 * C,) and gsums.dtype == torch.float32
    gf, xhat = gt.float(), (xt.float() - mean) * inv
    mags = torch.cat([gf.abs().sum(bn_cuda.DIMS), (gf * xhat).abs().sum(bn_cuda.DIMS)]).numpy()
    want = np.concatenate([np.asarray(want_dbias), np.asarray(want_dscale)])
    assert (np.abs(gsums.numpy() - want) / mags).max() <= 2e-5
    dx = bn_cuda.dx(gt, xt, sums, gsums, torch.as_tensor(scale), 1e-5)
    assert dx.dtype == tdtype
    want_dx = np.transpose(np.asarray(want_dx.astype(jnp.float32)), (0, 3, 1, 2))
    rtol = 2e-5 if dtype == "float32" else 2**-7
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=rtol, atol=2e-5)
