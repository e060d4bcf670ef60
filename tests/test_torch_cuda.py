"""The CUDA kernels against their plain PyTorch twins, on the card: the
propagation kernels, the train-mode BatchNorm kernels (and the modules of
models/fused_bn.py on them), and a CUDA graph of k train steps against k
eager steps.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one. The file imports no JAX, so on a machine without it run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: pred to atol 1e-4 (a convex mix of labels in [0, 1]; the kernel
and cuBLAS sum the dot products in other orders), argmax exactly equal. On
dyadic or 2**-5-grid inputs every dot product is exact in any summation
order, so a near-tie cannot send the two sides' selections apart: there
the kernels, their steps and their phases equal their twins bit for bit.
"""

import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
from radar_sounder_crw_tpu_torch.ops.labelprop import (
    NEG_INVALID,
    LabelPropConfig,
    _affinity,
    _chunk_lists,
    _label_chain,
    _prop_step,
    _weights_all_frames,
    _winners_all_frames,
    propagate_labels,
    propagate_all_reference,
    propagate_labels_batched,
    propagate_seq_reference,
    radius_mask,
)

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(K, N, C, M, radius, nslots, seed, ties, device):
    rng = np.random.default_rng(seed)
    if ties:  # dyadic values: exact dot products, real ties
        feats = rng.integers(-2, 3, (K, N, C)).astype(np.float32) / 2
        query = rng.integers(-2, 3, (N, C)).astype(np.float32) / 2
    else:
        feats = rng.standard_normal((K, N, C)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        query = rng.standard_normal((N, C)).astype(np.float32)
        query /= np.linalg.norm(query, axis=-1, keepdims=True)
    labels = rng.random((K, N, M)).astype(np.float32)
    valid = (rng.random(K) < 0.9) & (np.arange(K) < nslots)
    valid[0] = True
    bias = np.where(valid, 0.0, NEG_INVALID).astype(np.float32)
    mask = radius_mask(N, 1, radius)
    return [torch.as_tensor(a, device=device) for a in (feats, query, mask, bias, labels)]


@pytest.mark.parametrize(
    "K,N,C,M,knn,radius,temp,nslots,ties",
    [
        (101, 190, 128, 6, 20, 60, 0.01, 101, False),  # MC3 step, saturated ring
        (101, 190, 128, 6, 20, 60, 0.01, 12, False),  # MC3 step, valid prefix
        (101, 190, 128, 6, 20, 60, 0.01, 2, False),  # MC3 prefix at t = 1
        (101, 190, 128, 6, 20, 60, 0.01, 3, False),  # t = 2
        (101, 190, 128, 6, 20, 60, 0.01, 38, False),  # t = 37
        (101, 113, 128, 5, 20, 10, 0.1, 101, False),  # SHARAD step
        (101, 113, 128, 5, 20, 10, 0.1, 50, True),  # tie-heavy
        (4, 5, 8, 3, 30, 3, 0.07, 2, False),  # knn above the candidate count
        (7, 30, 7, 4, 9, 5, 0.07, 7, False),  # C not a multiple of 4
        (160, 400, 64, 4, 20, 30, 0.05, 160, False),  # 7 query tiles, long chunks
        (101, 190, 128, 6, 40, 60, 0.01, 101, True),  # dyadic ties, knn above 32
        (5, 65, 36, 3, 25, 5, 0.07, 4, True),  # two query tiles, a partial channel stage
        (9, 70, 132, 4, 1, 8, 0.1, 9, False),  # knn = 1, C = 132
    ],
)
def test_kernel_matches_plain_step(cuda, K, N, C, M, knn, radius, temp, nslots, ties):
    args = _inputs(K, N, C, M, radius, nslots, 0, ties, cuda)
    before = labelprop_cuda.launches["prop_step"]
    got = labelprop_cuda.prop_step(*args, temp, knn, nslots)
    want = _prop_step(*args, temp, knn, nslots)
    torch.cuda.synchronize()
    assert labelprop_cuda.launches["prop_step"] == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= ATOL
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    if ties:  # exact dot products: the same winners, weights and sums
        assert torch.equal(got, want)


@pytest.mark.parametrize("chunk_rows", [None, 128, 300, 5000])
def test_block_topk_lists_equal_the_twin(cuda, chunk_rows):
    """Step 1's chunk lists equal `_chunk_lists` exactly on dyadic inputs,
    at the planned chunk and at chunks that split runs of equal values."""
    K, N, C, M, knn, nslots = 101, 190, 128, 6, 20, 64
    feats, query, mask, bias, _ = _inputs(K, N, C, M, 60, nslots, 1, True, cuda)
    if chunk_rows is None:
        chunk_rows = labelprop_cuda.step_chunk_rows(N, knn, nslots, cuda)
    vals, idx = labelprop_cuda.prop_step_tiles(feats, query, mask, bias, 0.01, knn, nslots,
                                               chunk_rows)
    flat = _affinity(feats[None], query[None], mask, bias, 0.01, nslots)
    want_v, want_i = _chunk_lists(flat, knn, chunk_rows)
    assert torch.equal(vals, want_v[0])
    assert torch.equal(idx.long(), want_i[0])


def test_propagation_cuda_matches_plain(cuda):
    rng = np.random.default_rng(3)
    T, N, C, M = 30, 40, 32, 4
    emb = rng.standard_normal((T, N, C)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    seed = np.eye(M, dtype=np.float32)[rng.integers(0, M, N)]
    cfg = LabelPropConfig(cxt_size=8, radius=6, temperature=0.07, knn=5, long_mem=(0, 3))
    before = labelprop_cuda.launches["prop_step"]
    soft_k, pred_k = propagate_labels(emb, seed, cfg, kernel="cuda")
    assert labelprop_cuda.launches["prop_step"] == before + T - 1
    soft_p, pred_p = propagate_labels(emb, seed, cfg, kernel="torch")
    assert (soft_k - soft_p).abs().max().item() <= ATOL
    assert torch.equal(pred_k, pred_p)


def test_kernel_rejects_bad_inputs(cuda):
    args = _inputs(4, 6, 8, 3, 3, 4, 0, False, cuda)
    with pytest.raises(ValueError, match="nslots"):
        labelprop_cuda.prop_step(*args, 0.1, 3, 5)
    with pytest.raises(ValueError, match="knn"):
        labelprop_cuda.prop_step(*args, 0.1, 0, 4)
    with pytest.raises(ValueError, match="class count"):
        labelprop_cuda.prop_step(*args[:4], torch.zeros((4, 6, 200), device=cuda), 0.1, 3, 4)
    with pytest.raises(ValueError, match="contiguous float32"):
        labelprop_cuda.prop_step(args[0].double(), *args[1:], 0.1, 3, 4)


def _seq_inputs(B, T, N, C, M, seed, device):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, T, N, C)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    emb = np.round(emb * 32) / 32  # exact dot products
    seeds = rng.random((B, N, M)).astype(np.float32)
    return torch.as_tensor(emb, device=device), torch.as_tensor(seeds, device=device)


@pytest.mark.parametrize(
    "B,T,N,C,M,cxt,radius,temp,knn,long_mem",
    [
        (3, 20, 24, 32, 4, 8, 5, 0.1, 6, (0,)),  # small, ring wraps
        (2, 12, 40, 7, 3, 20, 9, 0.05, 20, (0,)),  # C not a multiple of 4
        (3, 12, 10, 8, 3, 4, 3, 0.07, 3, (0, 2)),  # pins and a wrapping ring
    ],
)
def test_seq_kernel_matches_plain_twin(cuda, B, T, N, C, M, cxt, radius, temp, knn, long_mem):
    emb, seeds = _seq_inputs(B, T, N, C, M, 0, cuda)
    mask = torch.as_tensor(radius_mask(N, 1, radius), device=cuda)
    before = labelprop_cuda.launches["prop_seq"]
    got = labelprop_cuda.prop_seq(emb, seeds, mask, long_mem, cxt, temp, knn)
    want = propagate_seq_reference(emb, seeds, mask, long_mem, cxt, temp, knn)
    torch.cuda.synchronize()
    assert labelprop_cuda.launches["prop_seq"] == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= ATOL
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert torch.equal(got, want)  # exact dot products on the grid
    # the batched entry point routes 'auto' on the card to this kernel
    cfg = LabelPropConfig(cxt_size=cxt, radius=radius, temperature=temp, knn=knn,
                          long_mem=long_mem)
    soft, _ = propagate_labels_batched(emb, seeds, cfg)
    assert labelprop_cuda.launches["prop_seq"] == before + 2
    assert torch.equal(soft, got)


@pytest.mark.parametrize(
    "B,T,N,C,M,cxt,radius,temp,knn,long_mem",
    [
        (3, 12, 10, 8, 3, 4, 3, 0.07, 3, (0, 2)),  # wrapping ring, pins not yet written
        (2, 9, 12, 8, 4, 4, 3, 0.07, 5, ()),  # no pins
        (2, 6, 5, 8, 3, 2, 3, 0.07, 15, (0,)),  # knn above the early frames' candidates
        (2, 12, 40, 7, 3, 20, 9, 0.05, 20, (0,)),  # C not a multiple of 4
        (3, 30, 50, 128, 6, 10, 10, 0.1, 40, (0, 3)),  # survey width, knn above 32
        (2, 9, 70, 36, 3, 4, 5, 0.07, 25, (0, 2)),  # two query tiles, a partial channel stage
    ],
)
def test_seq_phases_equal_their_twins(cuda, B, T, N, C, M, cxt, radius, temp, knn, long_mem):
    """Phase A's lists equal `_winners_all_frames` exactly, and phase B on
    them equals `_label_chain` bit for bit."""
    emb, seeds = _seq_inputs(B, T, N, C, M, 5, cuda)
    mask = torch.as_tensor(radius_mask(N, 1, radius), device=cuda)
    src, e = labelprop_cuda.prop_seq_select(emb, mask, long_mem, cxt, temp, knn)
    f, i, e_want = _winners_all_frames(emb, mask, long_mem, cxt, temp, knn)
    got_f, got_i = labelprop_cuda.unpack_sources(src.long(), N)
    assert torch.equal(got_f, f) and torch.equal(got_i, i) and torch.equal(e, e_want)
    soft = labelprop_cuda.prop_seq_chain(src, e, seeds)
    assert torch.equal(soft, _label_chain((f, i, e_want), seeds))
    assert torch.equal(soft, labelprop_cuda.prop_seq(emb, seeds, mask, long_mem, cxt, temp, knn))


def test_seq_kernel_single_frame_makes_no_launch(cuda):
    emb, seeds = _seq_inputs(2, 1, 6, 8, 3, 1, cuda)
    mask = torch.as_tensor(radius_mask(6, 1, 3), device=cuda)
    before = labelprop_cuda.launches["prop_seq"]
    soft = labelprop_cuda.prop_seq(emb, seeds, mask, (0,), 4, 0.1, 3)
    assert labelprop_cuda.launches["prop_seq"] == before
    assert torch.equal(soft[:, 0], seeds)


def test_cuda_seq_refuses_cpu_tensors_and_devices(cuda):
    emb = np.zeros((1, 3, 4, 8), np.float32)
    seed = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]][None]
    with pytest.raises(ValueError, match="CUDA device"):
        propagate_labels_batched(emb, seed, LabelPropConfig(), kernel="cuda_seq", device="cpu")
    e, s = torch.as_tensor(emb, device=cuda), torch.as_tensor(seed, device=cuda)
    mask = torch.zeros((4, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        labelprop_cuda.prop_seq(e, s.cpu(), mask, (0,), 2, 0.1, 2)


@pytest.mark.parametrize(
    "B,T,N,C,M,cxt,radius,temp,knn,long_mem,ties",
    [
        (3, 12, 10, 8, 3, 4, 3, 0.07, 3, (0, 2), False),  # pins and a wrapping ring
        (2, 9, 12, 8, 4, 4, 3, 0.07, 5, (), False),  # no pins
        (2, 6, 5, 8, 3, 2, 3, 0.07, 40, (0,), False),  # knn above the candidate count
        (2, 10, 24, 32, 4, 6, 5, 0.1, 70, (0,), False),  # more winners than a warp's lanes
        (2, 8, 16, 16, 40, 4, 4, 0.1, 5, (0,), False),  # more classes than a warp's lanes
        (2, 10, 24, 32, 4, 6, 5, 0.1, 6, (0, 3), True),  # dyadic ties
        (2, 12, 40, 7, 3, 20, 9, 0.05, 20, (0,), False),  # C not a multiple of 4
        (2, 40, 190, 128, 6, 100, 60, 0.01, 20, (0,), False),  # MC3 width: labels in global memory
    ],
)
def test_resident_kernel_equals_its_twin(cuda, B, T, N, C, M, cxt, radius, temp, knn, long_mem,
                                         ties):
    emb, seeds = _seq_inputs(B, T, N, C, M, 2, cuda)
    if ties:  # dyadic halves: many exactly equal affinities
        emb = torch.round(emb * 4) / 2
    mask = torch.as_tensor(radius_mask(N, 1, radius), device=cuda)
    before = labelprop_cuda.launches["prop_all"]
    got = labelprop_cuda.prop_all(emb, seeds, mask, long_mem, cxt, temp, knn)
    want = propagate_all_reference(emb, seeds, mask, long_mem, cxt, temp, knn)
    torch.cuda.synchronize()
    assert labelprop_cuda.launches["prop_all"] == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "B,T,N,C,M,cxt,radius,temp,knn,long_mem,ties",
    [
        (3, 12, 24, 32, 4, 4, 5, 0.07, 6, (0, 2), False),  # a wrapping ring with pins
        (4, 30, 50, 128, 6, 10, 10, 0.1, 20, (0, 3), True),  # dyadic ties at survey width
        (2, 6, 5, 8, 3, 2, 3, 0.07, 40, (0,), False),  # knn above the candidate count
        (2, 9, 70, 36, 3, 4, 5, 0.07, 70, (0, 2), True),  # two query tiles, knn above 64
    ],
)
def test_resident_steps_equal_their_twins(cuda, B, T, N, C, M, cxt, radius, temp, knn, long_mem,
                                          ties):
    """The selection's weight lists (w = e / den, ascending candidate row)
    equal `_weights_all_frames` exactly, and the weights-only chain on them
    equals `_label_chain(..., weights_only=True)` and `prop_all` bit for bit."""
    emb, seeds = _seq_inputs(B, T, N, C, M, 7, cuda)
    if ties:
        emb = torch.round(emb * 4) / 2
    mask = torch.as_tensor(radius_mask(N, 1, radius), device=cuda)
    before = labelprop_cuda.launches["prop_all"]
    src, w = labelprop_cuda.prop_all_weights(emb, mask, long_mem, cxt, temp, knn)
    f, i, w_want = _weights_all_frames(emb, mask, long_mem, cxt, temp, knn)
    got_f, got_i = labelprop_cuda.unpack_sources(src.long(), N)
    assert torch.equal(got_f, f) and torch.equal(got_i, i) and torch.equal(w, w_want)
    soft = labelprop_cuda.prop_all_chain(src, w, seeds)
    assert labelprop_cuda.launches["prop_all"] == before + 2
    assert torch.equal(soft, _label_chain((f, i, w_want), seeds, weights_only=True))
    assert torch.equal(soft, labelprop_cuda.prop_all(emb, seeds, mask, long_mem, cxt, temp, knn))


def test_resident_kernel_single_frame_and_bad_inputs(cuda):
    emb, seeds = _seq_inputs(2, 1, 6, 8, 3, 1, cuda)
    mask = torch.as_tensor(radius_mask(6, 1, 3), device=cuda)
    before = labelprop_cuda.launches["prop_all"]
    soft = labelprop_cuda.prop_all(emb, seeds, mask, (0,), 4, 0.1, 3)
    assert labelprop_cuda.launches["prop_all"] == before
    assert torch.equal(soft[:, 0], seeds)
    emb, seeds = _seq_inputs(2, 4, 6, 8, 3, 1, cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        labelprop_cuda.prop_all(emb.double(), seeds, mask, (0,), 4, 0.1, 3)
    with pytest.raises(ValueError, match="class count"):
        labelprop_cuda.prop_all(emb, torch.zeros((2, 6, 200), device=cuda), mask, (0,), 4, 0.1, 3)
    with pytest.raises(ValueError, match="knn"):
        labelprop_cuda.prop_all(emb, seeds, mask, (0,), 4, 0.1, 0)
    # the tile core's lists hold knn <= 256: above it the kernel raises
    with pytest.raises(ValueError, match=r"knn must lie in \[1, 256\]"):
        labelprop_cuda.prop_all(emb, seeds, mask, (0,), 4, 0.1, 257)
    labelprop_cuda.prop_all(emb, seeds, mask, (0,), 4, 0.1, 256)
    assert labelprop_cuda.launches["prop_all"] == before + 1


def test_cuda_resident_route_agrees_with_cuda(cuda):
    """Both routes select the same winners (the affinities do not depend on
    the labels); their weighted sums differ by an ulp of summation order."""
    emb, seeds = _seq_inputs(1, 30, 40, 32, 4, 3, cuda)
    cfg = LabelPropConfig(cxt_size=8, radius=6, temperature=0.07, knn=5, long_mem=(0, 3))
    before = labelprop_cuda.launches["prop_all"]
    soft_r, pred_r = propagate_labels(emb[0], seeds[0], cfg, kernel="cuda_resident")
    assert labelprop_cuda.launches["prop_all"] == before + 1
    soft_c, pred_c = propagate_labels(emb[0], seeds[0], cfg, kernel="cuda")
    assert (soft_r - soft_c).abs().max().item() <= 1e-5
    assert (pred_r == pred_c).float().mean().item() >= 0.995
    # batched: one launch for the stack
    emb, seeds = _seq_inputs(3, 12, 10, 8, 3, 4, cuda)
    propagate_labels_batched(emb, seeds, cfg, kernel="cuda_resident")
    assert labelprop_cuda.launches["prop_all"] == before + 2


@pytest.mark.parametrize("T,N,M,pad", [
    (112, 50, 6, 15),  # the reseed cell: a 97-frame tail bucketed to 112, zero pad frames
    (100, 113, 5, 0),  # the seed cell's window
])
def test_auto_launches_prop_seq_once_for_one_radargram(cuda, T, N, M, pad):
    """One radargram under 'auto' at the benchmark cells' shapes (cxt 100,
    knn 20, radius 10): one prop_seq launch, no prop_step; its map equals
    kernel='cuda''s, bit for bit on grid inputs (both kernels equal their
    twin there)."""
    emb, seeds = _seq_inputs(1, T, N, 128, M, 7, cuda)
    if pad:
        emb[:, T - pad:] = 0
    cfg = LabelPropConfig(cxt_size=100, radius=10, temperature=0.1, knn=20)
    before = dict(labelprop_cuda.launches)
    soft, pred = propagate_labels(emb[0], seeds[0], cfg)
    torch.cuda.synchronize()
    assert labelprop_cuda.launches["prop_seq"] == before["prop_seq"] + 1
    assert labelprop_cuda.launches["prop_step"] == before["prop_step"]
    soft_c, pred_c = propagate_labels(emb[0], seeds[0], cfg, kernel="cuda")
    assert labelprop_cuda.launches["prop_step"] == before["prop_step"] + T - 1
    assert torch.equal(pred, pred_c)
    assert (soft - soft_c).abs().max().item() <= ATOL
    assert torch.equal(soft, soft_c)


def test_auto_past_the_limits_takes_the_plain_route(cuda):
    """knn = 300 is above every kernel's MAX_KNN: 'auto' decides before any
    launch to run the plain route on the card, equal to the CPU's; a kernel
    named for the same call still raises."""
    emb, seeds = _seq_inputs(2, 10, 40, 16, 4, 5, cuda)
    cfg = LabelPropConfig(cxt_size=8, radius=20, temperature=0.1, knn=300)
    before = dict(labelprop_cuda.launches)
    soft, pred = propagate_labels_batched(emb, seeds, cfg)
    soft1, _ = propagate_labels(emb[0], seeds[0], cfg)
    assert labelprop_cuda.launches == before
    want, want_pred = propagate_labels_batched(emb.cpu(), seeds.cpu(), cfg, device="cpu")
    assert soft.device.type == "cuda" and pred.dtype == torch.int32
    assert (soft.cpu() - want).abs().max().item() <= ATOL
    assert torch.equal(pred.cpu(), want_pred)
    assert (soft1.cpu() - want[0]).abs().max().item() <= ATOL
    for kernel in ("cuda_seq", "cuda", "cuda_resident"):
        with pytest.raises(ValueError, match="knn must lie"):
            propagate_labels_batched(emb, seeds, cfg, kernel=kernel)


def test_cli_test_all_matches_the_plain_route(cuda, tmp_path, monkeypatch):
    """`cli.test_all --correction --use_last` at toy size on the
    card, default device and kernel, against --kernel torch: the maps agree
    and the default route launched the whole-sequence kernel."""
    from radar_sounder_crw_tpu_torch.cli import test_all

    monkeypatch.setenv("RSCRW_DATA_ROOT", "/nonexistent-rscrw-root")
    monkeypatch.setenv("RSCRW_SYNTH_SCALE", "8")
    maps = {}
    for kernel in ("auto", "torch"):
        before = labelprop_cuda.launches["prop_seq"]
        args = test_all.get_args_parser().parse_args([
            "--model", "0", "--dataset", "3", "--seq_length", "8", "-c", "8", "-r", "6",
            "-k", "5", "--correction", "--use_last", "--no_plots",
            "--allow_untrained", "--kernel", kernel, "--output_folder", str(tmp_path / kernel)])
        maps[kernel] = test_all.main(args)
        launched = labelprop_cuda.launches["prop_seq"] - before
        assert launched >= 2 if kernel == "auto" else launched == 0
    assert maps["auto"].shape == maps["torch"].shape
    assert (maps["auto"] == maps["torch"]).mean() >= 0.995


# -- the train-mode BatchNorm kernels (csrc/bn_train.cu) ------------------------
BN_SHAPES = [  # (N, C, H, W): sums exact on the 2**-5 grid while N*H*W <= 16384
    (48, 3, 18, 18),  # bn0 at 16x16 patches (bfloat16: 8-byte vectors)
    (32, 64, 9, 9),  # the stem
    (96, 64, 5, 5),  # layer1
    (40, 512, 1, 1),  # layer4: a channel's elements C apart
    (7, 5, 3, 3),  # a partial tile, channels across tiles; scalar forward loads
    (33, 3, 18, 18),  # bn0's plane at an odd N
    (1, 64, 5, 5),  # one sample
    (18080, 512, 1, 1),  # layer4 of the bench step, real inputs: the 1e-5 rule
]
BN_EXACT = 16384  # the most N*H*W whose grid sums are exact in float32


def _grid(shape, seed, dtype, device):
    """Values k/32 in [-1, 1]: exact in bfloat16, every sum and product of
    two of them exact in float32 at these sizes."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(-32, 33, shape) / 32, dtype=dtype, device=device)


def _ulps(got, want):
    """|got - want| in units in the last place of `want` in its dtype."""
    bits = 23 if want.dtype == torch.float32 else 7
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), (e - 1 - bits).float())
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _bn_inputs(shape, dtype, device):
    """(x, g, exact): 2**-5-grid values where their sums are exact in
    float32, else real ones (x ~ 2 N(0, 1) + 0.5, g ~ N(0, 1))."""
    N, C, H, W = shape
    if N * H * W <= BN_EXACT:
        return _grid(shape, 0, dtype, device), _grid(shape, 1, dtype, device), True
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(shape, np.float32) * 2 + 0.5).to(device, dtype)
    g = torch.as_tensor(rng.standard_normal(shape, np.float32)).to(device, dtype)
    return x, g, False


def _relative_to_magnitudes(got, want, mags):
    return ((got - want).abs() / mags).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_kernels_equal_their_twins(cuda, shape, dtype):
    """Each kernel against its plain twin on the same inputs: the sums bit
    for bit on the grid (for the backward's sum g * xhat with statistics
    mean 0, var 1 and eps 0, so that xhat = x), on real inputs within 1e-5
    of the sums of magnitudes; mean and var bit for bit, y and dx within 2
    ulp of their dtype given the same sums; one launch a call."""
    from radar_sounder_crw_tpu_torch.ops import bn_cuda

    C = shape[1]
    x, g, exact = _bn_inputs(shape, dtype, cuda)
    scale = torch.linspace(0.5, 1.5, C, device=cuda)
    bias = torch.linspace(-0.25, 0.25, C, device=cuda)
    before = dict(bn_cuda.launches)
    sums = bn_cuda.stats(x)
    if exact:
        assert torch.equal(sums, bn_cuda.stats_reference(x))
    else:
        xf = x.float()
        mags = torch.cat([xf.abs().sum(bn_cuda.DIMS), (xf * xf).sum(bn_cuda.DIMS),
                          sums[-1:]])
        assert _relative_to_magnitudes(sums, bn_cuda.stats_reference(x), mags) <= 1e-5
    y, mean, var = bn_cuda.apply(x, sums, scale, bias, 1e-5)
    y_t, mean_t, var_t = bn_cuda.apply_reference(x, sums, scale, bias, 1e-5)
    assert y.dtype == dtype and torch.equal(mean, mean_t) and torch.equal(var, var_t)
    assert _ulps(y, y_t) <= 2
    n = float(sums[-1])
    unit = torch.cat([torch.zeros(C, device=cuda), torch.full((C,), n, device=cuda),
                      torch.tensor([n], device=cuda)])  # mean 0, var 1
    assert torch.equal(bn_cuda._moments_reference(unit, C, 0.0)[2],
                       torch.ones((1, C, 1, 1), device=cuda))
    gsums_unit = bn_cuda.backward_reduce(g, x, unit, 0.0)
    want_unit = bn_cuda.backward_reduce_reference(g, x, unit, 0.0)
    gsums = bn_cuda.backward_reduce(g, x, sums, 1e-5)
    want = bn_cuda.backward_reduce_reference(g, x, sums, 1e-5)
    if exact:
        assert torch.equal(gsums_unit, want_unit)
        assert torch.equal(gsums[:C], want[:C])
        assert (gsums[C:] - want[C:]).abs().max().item() <= 1e-6 * float(sums[-1])
    else:
        gf, xf = g.float(), x.float()
        mags = torch.cat([gf.abs().sum(bn_cuda.DIMS), (gf * xf).abs().sum(bn_cuda.DIMS)])
        assert _relative_to_magnitudes(gsums_unit, want_unit, mags) <= 1e-5
        m, _, inv = bn_cuda._moments_reference(sums, C, 1e-5)
        mags[C:] = (gf * ((xf - m) * inv)).abs().sum(bn_cuda.DIMS)
        assert _relative_to_magnitudes(gsums, want, mags) <= 1e-5
    dx = bn_cuda.dx(g, x, sums, gsums, scale, 1e-5)
    assert dx.dtype == dtype
    assert _ulps(dx, bn_cuda.dx_reference(g, x, sums, gsums, scale, 1e-5)) <= 2
    torch.cuda.synchronize()
    assert {k: bn_cuda.launches[k] - before[k] for k in before} == {
        "bn_stats": 1, "bn_apply": 1, "bn_backward_reduce": 2, "bn_dx": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_forward_repeats_its_bits_eagerly_and_in_a_graph(cuda, shape, dtype):
    """The tiled kernels' sums depend on the shape alone: two `stats` calls
    on one input are bit-equal, and so are two `apply` calls and two
    `backward_reduce` calls; a CUDA graph of `stats`, `apply`,
    `backward_reduce` and `dx` (the two reductions share the ticket
    counters, each launch resets them) replays bit-equal to the eager calls,
    twice. One launch a call, the capture included."""
    from radar_sounder_crw_tpu_torch.ops import bn_cuda

    C = shape[1]
    x, g, _ = _bn_inputs(shape, dtype, cuda)
    scale = torch.linspace(0.5, 1.5, C, device=cuda)
    bias = torch.linspace(-0.25, 0.25, C, device=cuda)
    sums = bn_cuda.stats(x)
    assert torch.equal(bn_cuda.stats(x), sums)
    y, mean, var = bn_cuda.apply(x, sums, scale, bias, 1e-5)
    again = bn_cuda.apply(x, sums, scale, bias, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(again, (y, mean, var)))
    gsums = bn_cuda.backward_reduce(g, x, sums, 1e-5)
    assert torch.equal(bn_cuda.backward_reduce(g, x, sums, 1e-5), gsums)
    dx = bn_cuda.dx(g, x, sums, gsums, scale, 1e-5)
    torch.cuda.synchronize()
    before = dict(bn_cuda.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_sums = bn_cuda.stats(x)
        g_out = bn_cuda.apply(x, g_sums, scale, bias, 1e-5)
        g_gsums = bn_cuda.backward_reduce(g, x, g_sums, 1e-5)
        g_dx = bn_cuda.dx(g, x, g_sums, g_gsums, scale, 1e-5)
    assert {k: bn_cuda.launches[k] - before[k] for k in before} == {
        "bn_stats": 1, "bn_apply": 1, "bn_backward_reduce": 1, "bn_dx": 1}
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_sums, sums)
        assert all(torch.equal(a, b) for a, b in zip(g_out, (y, mean, var)))
        assert torch.equal(g_gsums, gsums) and torch.equal(g_dx, dx)
    # the counters are zero after the replays
    assert torch.equal(bn_cuda.stats(x), sums)
    assert torch.equal(bn_cuda.backward_reduce(g, x, sums, 1e-5), gsums)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_backward_reduce_takes_g_at_another_alignment(cuda, shape, dtype):
    """g a view one element past a fresh allocation (2 or 4 bytes off the
    16-byte alignment of x, as an autograd gradient's address may be): the
    plan takes the smaller alignment, so both inputs are read with narrower
    vectors, and the sums still equal the twin's bit for bit on the grid
    (and the aligned call's), within 1e-5 of the sums of magnitudes on real
    inputs. One launch a call."""
    from radar_sounder_crw_tpu_torch.ops import bn_cuda

    C = shape[1]
    x, g, exact = _bn_inputs(shape, dtype, cuda)
    shifted = torch.empty(g.numel() + 1, dtype=dtype, device=cuda)[1:].view(g.shape)
    shifted.copy_(g)
    assert bn_cuda.alignment(x, shifted) == g.element_size() < bn_cuda.alignment(x, g)
    sums = bn_cuda.stats(x)
    before = bn_cuda.launches["bn_backward_reduce"]
    got = bn_cuda.backward_reduce(shifted, x, sums, 1e-5)
    aligned = bn_cuda.backward_reduce(g, x, sums, 1e-5)
    want = bn_cuda.backward_reduce_reference(g, x, sums, 1e-5)
    torch.cuda.synchronize()
    assert bn_cuda.launches["bn_backward_reduce"] - before == 2
    if exact:
        assert torch.equal(got[:C], want[:C]) and torch.equal(got[:C], aligned[:C])
        assert (got[C:] - want[C:]).abs().max().item() <= 1e-6 * float(sums[-1])
    m, _, inv = bn_cuda._moments_reference(sums, C, 1e-5)
    gf = g.float()
    mags = torch.cat([gf.abs().sum(bn_cuda.DIMS),
                      (gf * ((x.float() - m) * inv)).abs().sum(bn_cuda.DIMS)])
    assert _relative_to_magnitudes(got, want, mags) <= 1e-5
    assert _relative_to_magnitudes(got, aligned, mags) <= 1e-5


def test_bn_kernels_reject_bad_inputs(cuda):
    from radar_sounder_crw_tpu_torch.ops import bn_cuda

    x = torch.zeros((4, 3, 5, 5), device=cuda)
    sums = bn_cuda.stats(x)
    one = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="contiguous 4-D"):
        bn_cuda.stats(x.transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous 4-D"):
        bn_cuda.stats(x.half())
    with pytest.raises(ValueError, match="positions"):
        bn_cuda.stats(torch.zeros((4, 0, 5, 5), device=cuda))
    with pytest.raises(ValueError, match="sums"):
        bn_cuda.apply(x, sums[:-1], one, one, 1e-5)
    with pytest.raises(ValueError, match="scale"):
        bn_cuda.apply(x, sums, one.cpu(), one, 1e-5)
    with pytest.raises(ValueError, match="like x"):
        bn_cuda.backward_reduce(x.bfloat16(), x, sums, 1e-5)


@pytest.mark.parametrize("variant", ["fused", "lean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_and_lean_batchnorm_on_the_card(cuda, variant, dtype):
    """One train-mode step of each module on the card against the same
    module on the CPU (the twins): outputs, input and parameter gradients,
    running statistics within float32 summation noise; the card's run
    launches the kernels (fused: all four, lean: the statistics)."""
    from radar_sounder_crw_tpu_torch.models import make_norm
    from radar_sounder_crw_tpu_torch.ops import bn_cuda

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((64, 32, 6, 6)) * 2 + 0.5, dtype=dtype)
    cot = torch.as_tensor(rng.standard_normal((64, 32, 6, 6)), dtype=dtype)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        bn = make_norm(variant, 32).to(dev).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 32))
            bn.bias.copy_(torch.linspace(-0.3, 0.3, 32))
        xd = x.to(dev).requires_grad_(True)
        before = dict(bn_cuda.launches)
        y = bn(xd)
        (y.float() * cot.to(dev).float()).sum().backward()
        launched = {k: bn_cuda.launches[k] - before[k] for k in before}
        got[dev.type] = [t.detach().float().cpu() for t in (
            y, xd.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var)]
        if dev.type == "cuda":
            want = ({"bn_stats": 1, "bn_apply": 1, "bn_backward_reduce": 1, "bn_dx": 1}
                    if variant == "fused" else
                    {"bn_stats": 1, "bn_apply": 0, "bn_backward_reduce": 0, "bn_dx": 0})
            assert launched == want
        else:
            assert not any(launched.values())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("y", "dx", "dscale", "dbias", "mean", "var"), got["cuda"],
                          got["cpu"]):
        scale = float(b.abs().max()) or 1.0
        assert (a - b).abs().max().item() <= tol * scale, name


@pytest.mark.parametrize("fused_bn", [None, "fused"])
def test_graphed_chunk_equals_eager_steps(cuda, fused_bn, tmp_path):
    """steps_per_dispatch = 3 on the card, cuDNN deterministic: two chunks
    through `train_chunk` (the first eager, the second one graph replay)
    equal six `train_step` calls of the same trainer configuration bit for
    bit: losses, parameters and buffers, Adam's state. A checkpoint of the
    graphed trainer restores into a fresh one whose next chunk (captured
    anew) equals the eager trainer's next three steps."""
    from radar_sounder_crw_tpu_torch.train import CheckpointManager, CRWTrainConfig, CRWTrainer
    from radar_sounder_crw_tpu_torch.train import step_graph

    torch.backends.cudnn.deterministic = True
    try:
        B, T, N, hw = 2, 5, 6, (16, 16)
        rng = np.random.default_rng(0)
        data = torch.as_tensor(rng.standard_normal((9, B, T, N, *hw)).astype(np.float32),
                               device=cuda)
        cfg = CRWTrainConfig(model=1, batch_size=B, seq_length=T, lr=1e-3, tau=0.05,
                             fused_bn=fused_bn, steps_per_dispatch=3)
        graphed, eager = CRWTrainer(cfg, device=cuda), CRWTrainer(cfg, device=cuda)
        for tr in (graphed, eager):
            tr.init_state((T, N, *hw))
        eager.model.load_state_dict(graphed.model.state_dict(), strict=True)
        replays = step_graph.replays
        got = torch.cat([graphed.train_chunk(data[0:3]), graphed.train_chunk(data[3:6])])
        want = torch.stack([eager.train_step(b) for b in data[:6]])
        assert step_graph.replays == replays + 1 and graphed.step == eager.step == 6
        assert torch.equal(got, want)

        def same_state(a, b):
            for k, v in a.model.state_dict().items():
                assert torch.equal(v, b.model.state_dict()[k]), k
            sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
            for i in sa:
                for k in sa[i]:
                    assert torch.equal(sa[i][k], sb[i][k]), (i, k)

        same_state(graphed, eager)
        mgr = CheckpointManager(tmp_path)
        mgr.save(graphed.step, graphed.state_dict())
        resumed = CRWTrainer(cfg, device=cuda)
        resumed.init_state((T, N, *hw))
        resumed.load_state_dict(mgr.restore())
        got = resumed.train_chunk(data[6:9])
        want = torch.stack([eager.train_step(b) for b in data[6:9]])
        assert torch.equal(got, want)
        same_state(resumed, eager)
    finally:
        torch.backends.cudnn.deterministic = False


# -- the ResNet's small-map convolutions as GEMMs (models/resnet.py) -------------
# (Cin, Cout, H, stride) of layer2.conv2, layer3.conv1, layer3.conv2,
# layer4.conv1 and layer4.conv2 on 16 x 16 patches, at the train cell's
# batch of 8 x 20 x 113 patches
SMALL_MAP_SHAPES = [(128, 128, 3, 1), (128, 256, 3, 2), (256, 256, 2, 1), (256, 512, 2, 2),
                    (512, 512, 1, 1)]


@pytest.fixture
def full_float32(cuda):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("cin,cout,size,stride", SMALL_MAP_SHAPES)
def test_small_map_conv_matches_cudnn_at_the_train_shapes(full_float32, cin, cout, size,
                                                           stride):
    """At N 18,080: the GEMM forward (autograd recording nothing), and
    `SmallMapConv`'s data and weight gradients, against a float64
    convolution of the same inputs within 2e-5 of its largest magnitude (a
    sum of up to 162,720 float32 products), and against cuDNN's float32
    convolution (TF32 off) within 2e-4: cuDNN's own weight gradient at 3 x 3
    and 2 x 2 maps is up to 8.8e-5 from float64 (on an H100), the GEMM's
    9.3e-7. `SmallMapConv`'s forward is cuDNN's, bit for bit."""
    from torch import nn

    from radar_sounder_crw_tpu_torch.models import resnet

    gen = torch.Generator().manual_seed(cin + cout + size)
    conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False).to(full_float32)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * (2 / (9 * cout)) ** 0.5)
    x = torch.randn(18080, cin, size, size, generator=gen).to(full_float32)
    out = (size + 2 - 3) // stride + 1
    g = torch.randn(18080, cout, out, out, generator=gen).to(full_float32)
    assert resnet.small_map(conv, x)
    results = {}
    for name, weight, inp in (("gemm", conv.weight, x), ("cudnn", conv.weight, x),
                              ("float64", conv.weight.double(), x.double())):
        w = weight.detach().requires_grad_(True)
        xi = inp.detach().requires_grad_(True)
        if name == "gemm":
            y = resnet.SmallMapConv.apply(xi, w, None, conv)
            with torch.no_grad():
                fwd = resnet.small_map_conv(conv, x, resnet.small_map_operands(
                    conv, w, None, size, size))
        else:
            y = torch.nn.functional.conv2d(xi, w, None, stride, 1)
        dx, dw = torch.autograd.grad(y, (xi, w), g.to(y.dtype))
        results[name] = [t.detach().double() for t in (y, dx, dw)]
    assert torch.equal(results["gemm"][0], results["cudnn"][0])
    results["gemm"][0] = fwd.double()
    for i, what in enumerate(("y", "dx", "dw")):
        want = results["float64"][i]
        scale = want.abs().max().item()
        errs = {k: (results[k][i] - want).abs().max().item() / scale for k in ("gemm", "cudnn")}
        apart = (results["gemm"][i] - results["cudnn"][i]).abs().max().item() / scale
        assert errs["gemm"] <= 2e-5 and apart <= 2e-4, (what, errs, apart)


def test_folded_small_map_forward_matches_the_plain_one(full_float32):
    """The ResNet encoder's folded eval forward (its five small-map
    convolutions as GEMMs on the folded weights, their operands kept with
    the fold) against the plain eval forward of the same weights (grad
    enabled: cuDNN's forward and eval BatchNorm, the small maps through
    `SmallMapConv`), on 16 x 16 patches: within 1e-5; 5 GEMM and 8 cuDNN
    convolutions a forward either way."""
    from radar_sounder_crw_tpu_torch.models import create_model, resnet

    model = create_model(1, True, device=full_float32, seed=3)
    gen = torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    x = torch.randn(2000, 2, 16, 16, generator=gen).to(full_float32)
    counts = []
    for grad in (False, True, False):
        before = dict(resnet.small_map_convs)
        with torch.set_grad_enabled(grad):
            emb = model(x).detach()
        counts.append({k: resnet.small_map_convs[k] - before[k] for k in before})
        if grad:
            plain = emb
        else:
            folded = emb
    assert counts == [{"gemm": 5, "cudnn": 8}] * 3
    assert sum(isinstance(k, tuple) for k in model._fold[1]) == 5
    assert (folded - plain).abs().max().item() <= 1e-5


# (cin, cout, kernel, stride, padding, map): the ResNet-10's convolutions that
# take `Im2colGradConv` on 16 x 16 patches, and the stem's 7x7, which
# `im2col_grad` leaves on cuDNN's gradients
IM2COL_SHAPES = [(3, 64, 7, 2, 3, 18), (64, 64, 3, 1, 1, 5), (64, 128, 3, 2, 1, 5),
                 (64, 128, 1, 2, 0, 5), (128, 256, 1, 2, 0, 3), (256, 512, 1, 2, 0, 2)]


@pytest.mark.parametrize("cin,cout,kernel,stride,padding,size", IM2COL_SHAPES)
def test_im2col_grad_conv_matches_cudnn_at_the_train_shapes(full_float32, cin, cout, kernel,
                                                            stride, padding, size):
    """At N 18,080: `Im2colGradConv`'s data and weight gradients against a
    float64 convolution of the same inputs within 2e-5 of its largest
    magnitude (a weight gradient sums up to 1,464,480 float32 products),
    and against cuDNN's float32 convolution (TF32 off) within 2e-4; its
    forward is cuDNN's, bit for bit, and two backward passes are bit-equal."""
    from torch import nn

    from radar_sounder_crw_tpu_torch.models import resnet

    gen = torch.Generator().manual_seed(cin + cout + kernel + size)
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False).to(full_float32)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                          * (2 / (kernel * kernel * cout)) ** 0.5)
    x = torch.randn(18080, cin, size, size, generator=gen).to(full_float32)
    assert not resnet.small_map(conv, x)
    out = (size + 2 * padding - kernel) // stride + 1
    g = torch.randn(18080, cout, out, out, generator=gen).to(full_float32)
    results = {}
    for name, weight, inp in (("im2col", conv.weight, x), ("again", conv.weight, x),
                              ("cudnn", conv.weight, x),
                              ("float64", conv.weight.double(), x.double())):
        w = weight.detach().requires_grad_(True)
        xi = inp.detach().requires_grad_(True)
        if name in ("im2col", "again"):
            y = resnet.Im2colGradConv.apply(xi, w, None, conv)
        else:
            y = torch.nn.functional.conv2d(xi, w, None, stride, padding)
        dx, dw = torch.autograd.grad(y, (xi, w), g.to(y.dtype))
        results[name] = [t.detach().double() for t in (y, dx, dw)]
    assert torch.equal(results["im2col"][0], results["cudnn"][0])
    assert all(torch.equal(a, b) for a, b in zip(results["im2col"], results["again"]))
    for i, what in enumerate(("dx", "dw"), 1):
        want = results["float64"][i]
        scale = want.abs().max().item()
        errs = {k: (results[k][i] - want).abs().max().item() / scale for k in ("im2col", "cudnn")}
        apart = (results["im2col"][i] - results["cudnn"][i]).abs().max().item() / scale
        assert errs["im2col"] <= 2e-5 and apart <= 2e-4, (what, errs, apart)


def test_a_span_holds_the_device_idle_of_a_host_sleep(cuda):
    """The port's spans and the card's events share kineto's clock: a 50 ms
    host sleep between two kernels inside a `crw.*` span reads, in the
    benchmark's attribution (portbench/spans.py `idle_by_span`), as at
    least 45 ms of device idle under that span."""
    import time

    from portbench import spans
    from portbench import trace as tr
    from radar_sounder_crw_tpu_torch.utils import span

    x = torch.randn(1024, 1024, device=cuda)
    (x @ x).sum().item()  # the context and cuBLAS warm
    with tr.profiled() as prof:
        with tr.span("window"):
            with span("crw.clock"):
                y = x @ x
                time.sleep(0.05)
                y = y @ x
            torch.cuda.synchronize()
    trace = tr.Trace(prof, 1, {}, {})
    idle = spans.of(trace).idle_by_span(trace.busy)
    print(f"idle s by span {idle}; busy {trace.busy_s} s of {trace.window_s} s")
    assert idle.get("crw.clock", 0.0) >= 0.045, idle
