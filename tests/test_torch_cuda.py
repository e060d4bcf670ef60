"""The CUDA propagation kernels against their plain PyTorch twins, on the card.

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
    # batched: one launch for the stack, or one per batch_block chunk
    emb, seeds = _seq_inputs(3, 12, 10, 8, 3, 4, cuda)
    soft, _ = propagate_labels_batched(emb, seeds, cfg, kernel="cuda_resident")
    chunked, _ = propagate_labels_batched(emb, seeds, cfg, kernel="cuda_resident", batch_block=2)
    assert labelprop_cuda.launches["prop_all"] == before + 4
    assert torch.equal(soft, chunked)


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


def test_cli_test_all_batched_matches_the_plain_route(cuda, tmp_path, monkeypatch):
    """`cli.test_all --batched --correction --use_last` at toy size on the
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
            "-k", "5", "--batched", "--correction", "--use_last", "--no_plots",
            "--allow_untrained", "--kernel", kernel, "--output_folder", str(tmp_path / kernel)])
        maps[kernel] = test_all.main(args)
        launched = labelprop_cuda.launches["prop_seq"] - before
        assert launched >= 2 if kernel == "auto" else launched == 0
    assert maps["auto"].shape == maps["torch"].shape
    assert (maps["auto"] == maps["torch"]).mean() >= 0.995
