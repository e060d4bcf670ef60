"""The plain twins of the kernels' decompositions (CPU).

`prop_step` finds each frame's winners as block top-k lists over candidate
chunks and a merge (`_winners_chunked`, `_chunk_lists`); `prop_seq` splits
the frame chain into every frame's winners from the embeddings alone
(`_winners_all_frames`, phase A) and the label chain (`_label_chain`,
phase B). Both decompositions must give exactly the plain step's winners
and the plain frame loop's labels, bit for bit: the embeddings here sit on a
2**-5 grid or on dyadic halves, where every dot product is exact. The
phases are also held to the JAX seq kernel in interpret mode on the shapes
of tests/test_torch_seq.py, soft labels to rtol 1e-4 / atol 1e-6 (CPU
products sum in other orders on the two sides) and maps exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.ops.labelprop import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu.ops.labelprop import propagate_labels_batched as jax_batched
from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
from radar_sounder_crw_tpu_torch.ops.labelprop import (
    NEG_INVALID,
    _affinity,
    _chunk_lists,
    _label_chain,
    _winners,
    _winners_all_frames,
    _winners_chunked,
    propagate_seq_reference,
    radius_mask,
)

TEMP = 0.07


def step_inputs(B, K, N, C, nslots, seed, dyadic=True):
    rng = np.random.default_rng(seed)
    if dyadic:  # halves in [-1, 1]: exact dot products, many exactly equal values
        feats = rng.integers(-2, 3, (B, K, N, C)).astype(np.float32) / 2
        query = rng.integers(-2, 3, (B, N, C)).astype(np.float32) / 2
    else:
        feats = rng.standard_normal((B, K, N, C)).astype(np.float32)
        query = rng.standard_normal((B, N, C)).astype(np.float32)
    valid = (rng.random(K) < 0.8) & (np.arange(K) < nslots)
    valid[0] = True
    bias = np.where(valid, 0.0, NEG_INVALID).astype(np.float32)
    return (torch.from_numpy(feats), torch.from_numpy(query),
            torch.from_numpy(radius_mask(N, 1, 3)), torch.from_numpy(bias))


@pytest.mark.parametrize(
    "K,N,C,knn,nslots,chunk",
    [
        (6, 10, 4, 5, 6, 7),  # chunks split runs of equal values
        (6, 10, 4, 5, 6, 1),  # one candidate per chunk
        (6, 10, 4, 12, 5, 8),  # knn above the chunk size
        (3, 5, 4, 40, 2, 4),  # knn above the candidate count
        (8, 12, 8, 7, 3, 9),  # a prefix nslots < K
        (8, 12, 8, 7, 8, 500),  # one chunk
    ],
)
def test_chunked_winners_equal_the_plain_winners(K, N, C, knn, nslots, chunk):
    feats, query, mask, bias = step_inputs(2, K, N, C, nslots, seed=K + chunk)
    want_idx, want_e = _winners(feats, query, mask, bias, TEMP, knn, nslots)
    idx, e = _winners_chunked(feats, query, mask, bias, TEMP, knn, nslots, chunk)
    assert torch.equal(idx, want_idx) and torch.equal(e, want_e)


def test_chunked_winners_on_real_values():
    feats, query, mask, bias = step_inputs(2, 7, 9, 16, 7, seed=3, dyadic=False)
    want = _winners(feats, query, mask, bias, TEMP, 6, 7)
    got = _winners_chunked(feats, query, mask, bias, TEMP, 6, 7, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chunk_lists_are_each_chunks_best_in_winner_order():
    feats, query, mask, bias = step_inputs(1, 4, 6, 4, 4, seed=8)
    flat = _affinity(feats, query, mask, bias, TEMP, 4)
    vals, idx = _chunk_lists(flat, 5, 7)  # 24 candidates: chunks of 7, 7, 7, 3
    assert vals.shape == (1, 6, 4, 5)
    for c in range(4):
        part = flat[..., 7 * c : 7 * c + 7]
        k = min(5, part.shape[-1])
        v, i = torch.sort(part, dim=-1, descending=True, stable=True)
        assert torch.equal(vals[:, :, c, :k], v[..., :k])
        assert torch.equal(idx[:, :, c, :k], i[..., :k] + 7 * c)
    # the last chunk holds 3 candidates: padded past them
    assert torch.isneginf(vals[:, :, 3, 3:]).all()
    assert (idx[:, :, 3, 3:] == torch.iinfo(torch.int32).max).all()


def seq_inputs(B, T, N, C, M, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, T, N, C)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    emb = np.round(emb * 32) / 32  # exact dot products
    if dyadic:
        emb = np.round(emb * 4) / 2
    seeds = rng.random((B, N, M)).astype(np.float32)
    return torch.from_numpy(emb), torch.from_numpy(seeds)


@pytest.mark.parametrize(
    "B,T,N,C,M,cxt,knn,long_mem,dyadic",
    [
        (3, 12, 10, 8, 3, 4, 3, (0, 2), False),  # the ring wraps, two pins
        (2, 9, 12, 8, 4, 4, 5, (), False),  # no pins
        (2, 9, 8, 8, 3, 3, 6, (0, 5), False),  # pin 5 read before it is written
        (2, 6, 5, 8, 3, 2, 15, (0,), False),  # knn above the early frames' candidates
        (2, 10, 9, 8, 3, 3, 5, (0, 2), True),  # dyadic ties
        (2, 1, 6, 8, 3, 3, 3, (0,), False),  # a single frame
    ],
)
def test_phases_equal_the_frame_loop(B, T, N, C, M, cxt, knn, long_mem, dyadic):
    emb, seeds = seq_inputs(B, T, N, C, M, seed=T + knn, dyadic=dyadic)
    mask = torch.from_numpy(radius_mask(N, 1, 3))
    lists = _winners_all_frames(emb, mask, long_mem, cxt, TEMP, knn)
    assert all(x.shape == (B, T - 1, N, knn) for x in lists)
    got = _label_chain(lists, seeds)
    want = propagate_seq_reference(emb, seeds, mask, long_mem, cxt, TEMP, knn)
    assert torch.equal(got, want)


def test_unwritten_pin_and_padding_entries():
    """A pin read before its frame is pushed has f = -1 and weight 0; a
    frame with fewer candidates than knn pads with (-1, 0, 0)."""
    emb, _ = seq_inputs(1, 5, 4, 8, 3, seed=2)
    mask = torch.zeros((4, 4))
    f, i, e = _winners_all_frames(emb, mask, (0, 3), 2, TEMP, 16)
    # frame 1: pins 0 (written, not yet valid) and 3 (not written), one ring
    # slot -> 12 candidates, all winners; pin 3's four nodes read no label
    assert ((f[0, 0, :, :12] == -1).sum(-1) == 4).all()
    assert (e[0, 0][f[0, 0] == -1] == 0).all()
    assert (f[0, 0, :, 12:] == -1).all() and (i[0, 0, :, 12:] == 0).all()
    assert (e[0, 0, :, 12:] == 0).all() and (e[0, 0, :, 0] == 1).all()
    # every real source is an earlier frame
    assert (f[0, 1] < 2).all() and (f[0, 3] < 4).all()


# the shapes of tests/test_torch_seq.py (PACK_SHAPES)
@pytest.mark.parametrize(
    "R,T,N,C,M,ctx,lm",
    [
        (5, 7, 10, 8, 3, 4, (0,)),
        (3, 6, 9, 8, 3, 8, (0,)),
        (4, 9, 12, 8, 4, 4, (0, 2)),
    ],
)
def test_phases_match_the_jax_seq_kernel(R, T, N, C, M, ctx, lm):
    rng = np.random.default_rng(13)
    emb = rng.standard_normal((R, T, N, C)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    seeds = np.eye(M, dtype=np.float32)[rng.integers(0, M, (R, N))]
    kw = dict(cxt_size=ctx, radius=3, temperature=TEMP, knn=3, long_mem=lm)
    want, want_pred = jax_batched(
        jnp.asarray(emb), jnp.asarray(seeds), JaxConfig(**kw), None, "pallas_seq_interpret"
    )
    mask = torch.from_numpy(radius_mask(N, 1, 3))
    lists = _winners_all_frames(torch.from_numpy(emb), mask, lm, ctx, TEMP, 3)
    soft = _label_chain(lists, torch.from_numpy(seeds))
    np.testing.assert_allclose(soft.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(soft.argmax(-1).numpy(), np.asarray(want_pred))


def test_phase_wrappers_on_cpu_are_the_twins():
    emb, seeds = seq_inputs(2, 8, 9, 8, 3, seed=4)
    mask = torch.from_numpy(radius_mask(9, 1, 3))
    before = dict(labelprop_cuda.launches)
    src, e = labelprop_cuda.prop_seq_select(emb, mask, (0, 2), 3, TEMP, 4)
    f, i = labelprop_cuda.unpack_sources(src.long(), 9)
    want_f, want_i, want_e = _winners_all_frames(emb, mask, (0, 2), 3, TEMP, 4)
    assert src.dtype == torch.int32
    assert torch.equal(f, want_f) and torch.equal(i, want_i) and torch.equal(e, want_e)
    soft = labelprop_cuda.prop_seq_chain(src, e, seeds)
    assert torch.equal(soft, labelprop_cuda.prop_seq(emb, seeds, mask, (0, 2), 3, TEMP, 4))

    feats, query, smask, bias = step_inputs(1, 6, 9, 4, 5, seed=6)
    vals, idx = labelprop_cuda.prop_step_tiles(feats[0], query[0], smask, bias, TEMP, 7, 5, 10)
    want_v, want_idx = _chunk_lists(_affinity(feats, query, smask, bias, TEMP, 5), 7, 10)
    assert torch.equal(vals, want_v[0]) and torch.equal(idx, want_idx[0])
    assert labelprop_cuda.launches == before  # no launch on the CPU


@pytest.mark.parametrize(
    "N,nslots,wave,rows",
    [
        (190, 101, 396, 256),  # saturated MC3 ring: 150 tiles, 2 per chunk
        (190, 2, 396, 128),  # frame 1: 380 candidates, 3 tiles, one each
        (400, 160, 396, 1152),  # 7 query tiles share the wave: 500 tiles, 9 per chunk
        (190, 101, 60, 1024),  # a smaller wave: 20 CTAs per query tile, 8 tiles each
    ],
)
def test_step_chunks_fill_the_card_once(monkeypatch, N, nslots, wave, rows):
    """`prop_step`'s chunk plan from the card's wave (SMs x CTAs per SM,
    asked of the card at first launch; here given): whole tiles per chunk,
    as few per chunk as fill the wave."""
    monkeypatch.setattr(labelprop_cuda, "_ask", lambda *args: wave)
    got = labelprop_cuda.step_chunk_rows(N, 20, nslots, "cpu")
    assert got == rows
    tiles = -(-(nslots * N) // labelprop_cuda.TILE_ROWS)
    q_tiles = -(-N // labelprop_cuda.TILE_QUERIES)
    chunks = -(-(nslots * N) // got)
    assert got % labelprop_cuda.TILE_ROWS == 0
    assert chunks * q_tiles <= max(wave, q_tiles) or chunks == tiles
