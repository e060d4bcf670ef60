"""The plain twins of the resident kernel's decomposition (CPU).

`prop_all` (csrc/prop_all.cu) splits the resident kernel's frame chain in
steps: every frame's winners from the embeddings alone, each list's weights
w_j = e_j / den (den summed in winner order) stored in ascending candidate
row, and a label chain of weighted sums alone. Their twins
`_weights_all_frames` and `_label_chain(..., weights_only=True)` must give
`propagate_all_reference`'s labels bit for bit, on exact (2**-5 grid,
dyadic) and on real-valued embeddings alike: both sides run the same
`_winners` on the same ring. They are also held to the JAX resident kernel
in interpret mode on the shapes of tests/test_torch_resident.py: maps
exactly equal, soft labels to 1e-5 absolute (CPU products sum in other
orders on the two sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.ops.labelprop import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu.ops.labelprop import propagate_labels as jax_propagate
from radar_sounder_crw_tpu.ops.labelprop import propagate_labels_batched as jax_batched
from radar_sounder_crw_tpu_torch.ops import labelprop_cuda
from radar_sounder_crw_tpu_torch.ops.labelprop import (
    _label_chain,
    _lists_all_frames,
    _row_order_weights,
    _weights_all_frames,
    _winners_all_frames,
    propagate_all_reference,
    radius_mask,
)

TEMP = 0.07
SOFT_ATOL = 1e-5


def make_inputs(B, T, N, C, M, seed, kind="grid", onehot=False):
    """emb (B, T, N, C): 'real' L2-normalized, 'grid' rounded to 2**-5
    (exact dot products), 'dyadic' halves in [-1, 1] (exact, many ties);
    seeds random soft labels, or one-hot."""
    rng = np.random.default_rng(seed)
    if kind == "dyadic":
        emb = rng.integers(-2, 3, (B, T, N, C)).astype(np.float32) / 2
    else:
        emb = rng.standard_normal((B, T, N, C)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        if kind == "grid":
            emb = np.round(emb * 32) / 32
    if onehot:
        seeds = np.eye(M, dtype=np.float32)[rng.integers(0, M, (B, N))]
    else:
        seeds = rng.random((B, N, M)).astype(np.float32)
    return torch.from_numpy(emb), torch.from_numpy(seeds)


def steps(emb, seeds, mask, long_mem, cxt, temperature, knn):
    """The decomposition: lists, then the weights-only chain."""
    lists = _weights_all_frames(emb, mask, long_mem, cxt, temperature, knn)
    return _label_chain(lists, seeds, weights_only=True)


@pytest.mark.parametrize("kind", ["grid", "dyadic", "real"])
@pytest.mark.parametrize(
    "B,T,N,C,M,cxt,knn,long_mem",
    [
        (1, 12, 10, 8, 4, 4, 5, ()),  # no pins, the ring wraps (T > cxt + 1)
        (1, 12, 10, 8, 4, 4, 5, (0,)),  # frame 0 in its pin and, until t > cxt, in the ring
        (2, 12, 10, 8, 4, 4, 5, (0, 2, 5)),  # three pins, pin 5 read before it is written
        (3, 9, 12, 8, 3, 3, 6, (0, 2)),  # B > 1
        (2, 6, 5, 8, 3, 2, 40, (0,)),  # knn above the candidate count of every frame
        (2, 7, 6, 8, 3, 10, 9, (0,)),  # the ring never fills: knn above the early frames'
        (2, 1, 6, 8, 3, 3, 3, (0,)),  # a single frame
    ],
)
def test_steps_equal_the_resident_twin(kind, B, T, N, C, M, cxt, knn, long_mem):
    emb, seeds = make_inputs(B, T, N, C, M, seed=T + knn + len(long_mem), kind=kind)
    mask = torch.from_numpy(radius_mask(N, 1, 3))
    lists = _weights_all_frames(emb, mask, long_mem, cxt, TEMP, knn)
    assert all(x.shape == (B, T - 1, N, knn) for x in lists)
    got = _label_chain(lists, seeds, weights_only=True)
    want = propagate_all_reference(emb, seeds, mask, long_mem, cxt, TEMP, knn)
    assert torch.equal(got, want)
    assert torch.equal(got[:, 0], seeds)


@pytest.mark.parametrize("long_mem", [(0, 2), (0,), ()])
def test_lists_are_in_candidate_row_order_not_source_order(long_mem):
    """On a wrapping ring the slot order departs from the frame order: the
    lists ascend in candidate row s*N + i, their sources do not. The rows
    themselves come from the same loop, stored in place of the values."""
    B, T, N, cxt, knn = 2, 12, 8, 4, 6
    emb, _ = make_inputs(B, T, N, 8, 3, seed=5)
    mask = torch.from_numpy(radius_mask(N, 1, 3))
    f, i, w = _weights_all_frames(emb, mask, long_mem, cxt, TEMP, knn)
    fw, iw, e = _winners_all_frames(emb, mask, long_mem, cxt, TEMP, knn)
    rows = _lists_all_frames(emb, mask, long_mem, cxt, TEMP, knn,
                             lambda idx, _: (idx, idx.float()))[2]
    order = rows.argsort(dim=-1)  # knn <= N: every entry is a candidate, rows distinct
    assert torch.equal(f, fw.gather(-1, order)) and torch.equal(i, iw.gather(-1, order))
    den = torch.zeros_like(e[..., :1])
    for j in range(knn):
        den = den + e[..., j, None]
    assert torch.equal(w, (e / den).gather(-1, order))
    sources = (f + 1) * N + i
    assert (sources.diff(dim=-1) < 0).any(), "fixture never wrapped"


def test_den_sums_in_winner_order_before_the_sort():
    """den runs over the winners as they come, the label sum over the rows:
    with e = (1, u, u, ...) for u = 2**-24, winner order gives den = 1 (each
    1 + u rounds back to 1), row order would give 1 + k*u."""
    k = 9
    u = 2.0 ** -24
    e = torch.tensor([[1.0] + [u] * (k - 1)])
    idx = torch.arange(k - 1, -1, -1)[None]  # the best winner is the last row
    rows, w = _row_order_weights(idx, e)
    assert torch.equal(rows, torch.arange(k)[None])
    assert torch.equal(w, torch.tensor([[u] * (k - 1) + [1.0]]))
    row_order_den = torch.zeros(())
    for x in [u] * (k - 1) + [1.0]:
        row_order_den = row_order_den + x
    assert row_order_den.item() > 1.0  # the other order is another number


def test_invalid_slot_and_padding_entries_weigh_nothing():
    """A frame can sit in two slots: with long_mem = (0,) frame 0 is in pin
    slot 0 and in the ring until t > cxt, and the pin is not valid for that
    time. With knn above the valid candidates the pin's entries win too, with
    w = 0 exactly, as do a not yet written pin's (f = -1) and the padding."""
    N, cxt, knn = 4, 3, 20
    emb, seeds = make_inputs(1, 6, N, 8, 3, seed=2)
    mask = torch.zeros((N, N))
    f, i, w = _weights_all_frames(emb, mask, (0, 4), cxt, TEMP, knn)
    # frame 1: pin 0 (frame 0, not valid), pin 4 (not written), one ring slot
    # (frame 0): 12 candidates, all of them winners, in row order
    assert f[0, 0, :, :12].tolist() == [[0] * 4 + [-1] * 4 + [0] * 4] * N
    assert i[0, 0, :, :12].tolist() == [[0, 1, 2, 3] * 3] * N
    assert (w[0, 0, :, :8] == 0).all() and (w[0, 0, :, 8:12] > 0).all()
    assert (f[0, 0, :, 12:] == -1).all() and (i[0, 0, :, 12:] == 0).all()
    assert (w[0, 0, :, 12:] == 0).all()
    # frame 5: frame 0 has left the ring (5 - 0 > 3), so its pin counts now;
    # pin 4 is written and still in the ring, so the pin slot weighs nothing;
    # 5 slots, all 20 candidates win
    t = 5
    pin0 = (f[0, t - 1] == 0)
    assert (w[0, t - 1][pin0] > 0).all() and pin0.sum() == N * N
    assert ((f[0, t - 1] == 4).sum(-1) == 2 * N).all()
    assert (w[0, t - 1, :, N : 2 * N] == 0).all()  # slot 1, rows N .. 2N - 1
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)
    got = _label_chain((f, i, w), seeds, weights_only=True)
    assert torch.equal(got, propagate_all_reference(emb, seeds, mask, (0, 4), cxt, TEMP, knn))


def assert_matches_jax(soft, want, want_pred):
    want = np.asarray(want)
    assert soft.shape == want.shape
    np.testing.assert_allclose(soft.numpy(), want, rtol=0, atol=SOFT_ATOL)
    np.testing.assert_array_equal(soft.argmax(-1).numpy(), np.asarray(want_pred))


# the shapes of tests/test_torch_resident.py (a), (b), (d), (e)
@pytest.mark.parametrize("long_mem", [(0,), (0, 2, 5), ()])
def test_steps_match_jax_resident_interpret(long_mem):
    emb, seeds = make_inputs(1, 12, 10, 8, 4, seed=31, kind="real", onehot=True)
    cfg = JaxConfig(cxt_size=4, radius=4, temperature=TEMP, knn=5, long_mem=long_mem)
    want, want_pred = jax_propagate(jnp.asarray(emb[0].numpy()), jnp.asarray(seeds[0].numpy()),
                                    cfg, None, "pallas_resident_interpret")
    mask = torch.from_numpy(radius_mask(10, 1, 4))
    assert_matches_jax(steps(emb, seeds, mask, long_mem, 4, TEMP, 5)[0], want, want_pred)


def test_batched_steps_match_jax_vmapped_resident_kernel():
    emb, seeds = make_inputs(3, 8, 10, 8, 4, seed=40, kind="real", onehot=True)
    cfg = JaxConfig(cxt_size=4, radius=4, temperature=TEMP, knn=4)
    want, want_pred = jax_batched(jnp.asarray(emb.numpy()), jnp.asarray(seeds.numpy()), cfg, None,
                                  "pallas_resident_interpret")
    mask = torch.from_numpy(radius_mask(10, 1, 4))
    assert_matches_jax(steps(emb, seeds, mask, (0,), 4, TEMP, 4), want, want_pred)


@pytest.mark.parametrize("long_mem", [(0,), (0, 3)])
def test_dyadic_ties_steps_maps_equal_jax(long_mem):
    emb, seeds = make_inputs(1, 10, 14, 8, 4, seed=7, kind="dyadic")
    cfg = JaxConfig(cxt_size=4, radius=3, temperature=TEMP, knn=5, long_mem=long_mem)
    want, want_pred = jax_propagate(jnp.asarray(emb[0].numpy()), jnp.asarray(seeds[0].numpy()),
                                    cfg, None, "pallas_resident_interpret")
    mask = torch.from_numpy(radius_mask(14, 1, 3))
    assert_matches_jax(steps(emb, seeds, mask, long_mem, 4, TEMP, 5)[0], want, want_pred)


def test_knn_above_the_candidate_count_matches_jax():
    emb, seeds = make_inputs(1, 6, 5, 8, 3, seed=9, kind="real", onehot=True)
    cfg = JaxConfig(cxt_size=2, radius=3, temperature=TEMP, knn=40)
    want, want_pred = jax_propagate(jnp.asarray(emb[0].numpy()), jnp.asarray(seeds[0].numpy()),
                                    cfg, None, "pallas_resident_interpret")
    mask = torch.from_numpy(radius_mask(5, 1, 3))
    # clipped as the entry points clip it, and unclipped: the same labels
    clipped = steps(emb, seeds, mask, (0,), 2, TEMP, min(40, (1 + 2) * 5))
    assert_matches_jax(clipped[0], want, want_pred)
    assert torch.equal(steps(emb, seeds, mask, (0,), 2, TEMP, 40), clipped)


def test_step_wrappers_on_cpu_are_the_twins():
    emb, seeds = make_inputs(2, 8, 9, 8, 3, seed=4)
    mask = torch.from_numpy(radius_mask(9, 1, 3))
    before = dict(labelprop_cuda.launches)
    src, w = labelprop_cuda.prop_all_weights(emb, mask, (0, 2), 3, TEMP, 4)
    f, i = labelprop_cuda.unpack_sources(src.long(), 9)
    want_f, want_i, want_w = _weights_all_frames(emb, mask, (0, 2), 3, TEMP, 4)
    assert src.dtype == torch.int32
    assert torch.equal(f, want_f) and torch.equal(i, want_i) and torch.equal(w, want_w)
    soft = labelprop_cuda.prop_all_chain(src, w, seeds)
    assert torch.equal(soft, labelprop_cuda.prop_all(emb, seeds, mask, (0, 2), 3, TEMP, 4))
    assert torch.equal(soft, propagate_all_reference(emb, seeds, mask, (0, 2), 3, TEMP, 4))
    assert labelprop_cuda.launches == before  # no launch on the CPU


@pytest.mark.parametrize("knn,ok", [(1, True), (256, True), (257, False), (0, False)])
def test_every_whole_sequence_kernel_takes_knn_up_to_256(knn, ok):
    """The tile core holds one list entry per lane per 32, at most 8: the
    checks `prop_seq` and `prop_all` run before a launch raise above
    MAX_KNN, they do not fall to the twin."""
    emb, _ = make_inputs(1, 3, 4, 8, 2, seed=1)
    mask = torch.zeros((4, 4))
    assert labelprop_cuda.MAX_KNN == 256
    if ok:
        labelprop_cuda._seq_checks(emb, mask, knn, 2)
    else:
        with pytest.raises(ValueError, match=r"knn must lie in \[1, 256\]"):
            labelprop_cuda._seq_checks(emb, mask, knn, 2)
