"""Routing past the kernels' limits and the int32 class map of
`propagate_labels(_batched)` (CPU).

* `auto` on a CUDA device takes the whole-sequence kernel for one
  radargram and for a batch alike, the per-frame kernel where the
  whole-sequence kernel's limits (knn <= 256, the class count, shared
  memory; `labelprop_cuda.fits`) refuse the call, and the plain route where
  both refuse it, decided before any launch; a kernel chosen by name is
  never switched. The card's answers are faked here by monkeypatching
  `labelprop_cuda._ask`, and the device check is lifted the way
  tests/test_torch_resident.py lifts it. With it lifted,
  `PropagationPipeline.__call__` and `reseed` reach the whole-sequence
  wrapper once a call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.ops.labelprop import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu.ops.labelprop import propagate_labels as jax_propagate
from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
from radar_sounder_crw_tpu_torch.ops import labelprop, labelprop_cuda
from radar_sounder_crw_tpu_torch.ops.labelprop import (
    LabelPropConfig,
    _route,
    propagate_labels,
    propagate_labels_batched,
    propagate_seq_reference,
    radius_mask,
)
from test_torch_resident import make_inputs

RTOL, ATOL = 1e-4, 1e-6
CUDA = torch.device("cuda")
SMEM_LIMIT = 227 * 1024


def fake_card(monkeypatch, max_classes=128, step_bytes=None, select_bytes=None,
              chain_bytes=None):
    """Answer `labelprop_cuda._ask` as a card would, without one: shared
    memory grows with knn (and the prefix for the selection, the lists for
    the chain), under the limit up to knn = 256 unless a test pushes one of
    them past it."""
    step_bytes = step_bytes or (lambda knn: 800 * knn)
    select_bytes = select_bytes or (lambda knn, ns: 800 * knn + 100 * ns)
    chain_bytes = chain_bytes or (lambda T, N, M, knn, in_smem: 4 * T * N * M if in_smem
                                  else 8 * N * knn)
    answers = {
        "max_classes": lambda: max_classes,
        "max_dynamic_smem": lambda: SMEM_LIMIT,
        "smem_bytes": step_bytes,
        "select_smem_bytes": select_bytes,
        "chain_smem_bytes": chain_bytes,
    }
    asked = []

    def ask(name, device, fn, *args):
        assert device.type == "cuda"
        asked.append((name, fn))
        return answers[fn](*args)

    monkeypatch.setattr(labelprop_cuda, "_ask", ask)
    return asked


# -- F1: the predicate --------------------------------------------------------


@pytest.mark.parametrize("route", ["cuda", "cuda_seq", "cuda_resident"])
def test_fits_answers_the_wrappers_limits(monkeypatch, route):
    fake_card(monkeypatch)
    dims = dict(T=100, N=50, M=6, L=1, cxt=100)
    assert labelprop_cuda.fits(route, CUDA, knn=20, **dims)
    assert labelprop_cuda.fits(route, CUDA, knn=labelprop_cuda.MAX_KNN, **{**dims, "T": 2})
    assert not labelprop_cuda.fits(route, CUDA, knn=labelprop_cuda.MAX_KNN + 1, **dims)
    assert not labelprop_cuda.fits(route, CUDA, knn=0, **dims)
    assert not labelprop_cuda.fits(route, CUDA, knn=20, **{**dims, "M": 129})
    assert labelprop_cuda.fits(route, CUDA, knn=20, **{**dims, "M": 128})


def test_fits_shared_memory_of_each_kernel(monkeypatch):
    fake_card(monkeypatch)
    dims = dict(N=50, M=6, L=1, cxt=100)
    assert labelprop_cuda.fits("cuda", CUDA, T=100, knn=256, **dims)
    fake_card(monkeypatch, step_bytes=lambda knn: SMEM_LIMIT + 1)
    assert not labelprop_cuda.fits("cuda", CUDA, T=100, knn=20, **dims)
    assert labelprop_cuda.fits("cuda_seq", CUDA, T=100, knn=20, **dims)  # its own sizes
    fake_card(monkeypatch, select_bytes=lambda knn, ns: SMEM_LIMIT + 1)
    assert not labelprop_cuda.fits("cuda_seq", CUDA, T=100, knn=20, **dims)
    assert labelprop_cuda.fits("cuda_seq", CUDA, T=1, knn=20, **dims)  # no launch at T = 1
    # the chain: lists past the limit in shared memory but not in global
    fake_card(monkeypatch, chain_bytes=lambda T, N, M, knn, s: SMEM_LIMIT + 1 if s else 64)
    assert labelprop_cuda.fits("cuda_resident", CUDA, T=100, knn=20, **dims)
    fake_card(monkeypatch, chain_bytes=lambda T, N, M, knn, s: SMEM_LIMIT + 1)
    assert not labelprop_cuda.fits("cuda_seq", CUDA, T=100, knn=20, **dims)
    # the selection's prefix is L + min(T - 1, cxt)
    seen = []
    fake_card(monkeypatch, select_bytes=lambda knn, ns: seen.append(ns) or 0)
    labelprop_cuda.fits("cuda_seq", CUDA, T=7, knn=20, **dims)
    labelprop_cuda.fits("cuda_seq", CUDA, T=300, knn=20, **dims)
    assert seen == [1 + 6, 1 + 100]


def test_fits_on_the_cpu_loads_no_library(monkeypatch):
    def no_library(name):
        raise AssertionError("the CUDA library was built or loaded")

    monkeypatch.setattr(labelprop_cuda, "_library", no_library)
    assert not labelprop_cuda.fits("cuda_seq", torch.device("cpu"), 10, 5, 3, 4, 1, 4)
    # the plain CPU route never asks
    emb, seeds = make_inputs(2, 5, 6, 8, 3, seed=1)
    propagate_labels_batched(emb, seeds, LabelPropConfig(4, 3, 0.1, 300), device="cpu")


# -- F1: the route -------------------------------------------------------------


def seq_too_big(knn, ns):
    """The whole-sequence selection's shared memory past the card's limit."""
    return SMEM_LIMIT + 1


@pytest.mark.parametrize("seq_fits,kernel", [(False, "cuda"), (True, "cuda_seq")])
def test_route_auto_falls_to_the_plain_route_past_the_limits(monkeypatch, seq_fits, kernel):
    """'auto' takes the whole-sequence kernel, or the per-frame one where the
    card cannot hold the whole-sequence selection, and the plain route past
    both kernels' limits."""
    asked = fake_card(monkeypatch, select_bytes=None if seq_fits else seq_too_big)
    dims = dict(T=10, N=5, M=3, long_mem=(0,), cxt=4)
    assert _route("auto", CUDA, knn=20, **dims) == kernel
    assert asked  # the card was asked before the decision
    assert _route("auto", CUDA, knn=300, **dims) == "torch"
    assert _route("auto", CUDA, knn=20, **{**dims, "M": 200}) == "torch"
    # a kernel chosen by name is never switched: its wrapper raises at launch
    for named in ("cuda", "cuda_seq", "cuda_resident"):
        assert _route(named, CUDA, knn=300, **dims) == named
    with pytest.raises(ValueError, match="knn must lie"):
        labelprop_cuda._check_knn(300)
    # the CPU never reaches the predicate
    assert _route("auto", torch.device("cpu"), knn=20, **dims) == "torch"


def _lift_device_check(monkeypatch, calls):
    """auto resolves as on a GPU, `fits` asks the fake card as if the CPU
    tensors lay on it, and the kernels' wrappers record their calls and run
    their twins."""
    real_fits = labelprop_cuda.fits
    monkeypatch.setattr(labelprop, "resolve_kernel",
                        lambda kernel, device: "cuda_seq" if kernel == "auto" else kernel)
    monkeypatch.setattr(labelprop_cuda, "fits",
                        lambda route, device, *dims: real_fits(route, CUDA, *dims))
    monkeypatch.setattr(labelprop_cuda, "prop_seq",
                        lambda *a: calls.append("prop_seq") or propagate_seq_reference(*a))
    monkeypatch.setattr(labelprop_cuda, "prop_step",
                        lambda f, *a: calls.append("prop_step") or labelprop._prop_step(f, *a))


def test_auto_past_knn_limit_runs_the_plain_route(monkeypatch):
    """knn = 300 (above MAX_KNN) with the device check lifted: 'auto' never
    reaches a kernel wrapper and equals kernel='torch' and JAX 'xla'; at
    knn = 20 the same call reaches the wrapper."""
    fake_card(monkeypatch)
    calls = []
    _lift_device_check(monkeypatch, calls)
    emb, seeds = make_inputs(2, 8, 40, 16, 4, seed=3)
    big = LabelPropConfig(cxt_size=8, radius=20, temperature=0.1, knn=300)
    soft, pred = propagate_labels_batched(emb, seeds, big, device="cpu")
    soft1, pred1 = propagate_labels(emb[0], seeds[0], big, device="cpu")
    assert calls == []
    want, want_pred = propagate_labels_batched(emb, seeds, big, kernel="torch", device="cpu")
    assert torch.equal(soft, want) and torch.equal(pred, want_pred)
    assert torch.equal(soft1, want[0])
    j_soft, j_pred = jax_propagate(jnp.asarray(emb[0]), jnp.asarray(seeds[0]),
                                   JaxConfig(8, 20, 0.1, 300), None, "xla")
    np.testing.assert_allclose(soft1.numpy(), np.asarray(j_soft), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pred1.numpy(), np.asarray(j_pred))
    small = LabelPropConfig(cxt_size=8, radius=20, temperature=0.1, knn=20)
    propagate_labels_batched(emb, seeds, small, device="cpu")
    propagate_labels(emb[0], seeds[0], small, device="cpu")
    assert calls == ["prop_seq", "prop_seq"]


@pytest.mark.parametrize("card,want", [
    ("both fit", ["prop_seq"]),
    ("whole sequence too big", ["prop_step"] * 7),
    ("neither fits", []),
])
def test_auto_tries_the_whole_sequence_then_the_per_frame_kernel(monkeypatch, card, want):
    """The fallback order cuda_seq -> cuda -> plain, decided before any
    launch, at the entry points on grid inputs: one radargram and a batch of
    two reach the first wrapper that fits (the per-frame one a frame and
    radargram), and every route equals kernel='torch' bit for bit."""
    step_bytes = (lambda knn: SMEM_LIMIT + 1) if card == "neither fits" else None
    fake_card(monkeypatch, step_bytes=step_bytes,
              select_bytes=None if card == "both fit" else seq_too_big)
    calls = []
    _lift_device_check(monkeypatch, calls)
    emb, seeds = make_inputs(2, 8, 12, 8, 4, seed=9, ties=True, soft_seeds=True)
    cfg = LabelPropConfig(cxt_size=3, radius=4, temperature=0.1, knn=5, long_mem=(0, 2))
    soft1, pred1 = propagate_labels(emb[0], seeds[0], cfg, device="cpu")
    assert calls == want
    soft, pred = propagate_labels_batched(emb, seeds, cfg, device="cpu")
    assert calls == want + want * (2 if "prop_step" in want else 1)
    base, base_pred = propagate_labels_batched(emb, seeds, cfg, kernel="torch", device="cpu")
    assert torch.equal(soft, base) and torch.equal(pred, base_pred)
    assert torch.equal(soft1, base[0]) and torch.equal(pred1, base_pred[0])


@pytest.mark.parametrize("T,N,cxt,long_mem,frame,bucket", [
    (12, 10, 4, (0,), 3, 4),  # tail 9 padded to 12, the ring wraps
    (12, 10, 4, (0, 3), 2, 16),  # tail 10 padded to 16, wraps, two pins
    (9, 8, 20, (0,), 4, 1),  # no pad, no wrap
])
def test_pipeline_seed_and_reseed_launch_the_whole_sequence_kernel(monkeypatch, T, N, cxt,
                                                                    long_mem, frame, bucket):
    """`PropagationPipeline.__call__` and `reseed` under 'auto', device check
    lifted: one whole-sequence wrapper call each and never a per-frame one;
    maps bit-equal to kernel='torch' on dyadic embeddings."""
    fake_card(monkeypatch)
    calls = []
    _lift_device_check(monkeypatch, calls)
    M = 4
    emb = torch.from_numpy(make_inputs(1, T, N, 16, M, seed=T + frame, ties=True)[0][0])
    rng = np.random.default_rng(frame)
    seg, seg2 = (rng.integers(0, M, (2 * N, 6)) for _ in range(2))
    cfg = LabelPropConfig(cxt_size=cxt, radius=3, temperature=0.1, knn=6, long_mem=long_mem)
    pipes = []
    for kernel in ("auto", "torch"):
        pipe = PropagationPipeline(torch.nn.Identity(), cfg, M, kernel=kernel, device="cpu")
        pipe.encode = lambda seq: emb
        pipes.append(pipe)
    seq = np.zeros((T, N, 2, 2), dtype=np.float32)
    first, want = (p(seq, seg) for p in pipes)
    assert calls == ["prop_seq"]
    np.testing.assert_array_equal(first.prediction, want.prediction)
    assert first.change_idx == want.change_idx
    got, want = (p.reseed(seg2, frame, bucket) for p in pipes)
    assert calls == ["prop_seq", "prop_seq"]
    np.testing.assert_array_equal(got.prediction, want.prediction)
    np.testing.assert_array_equal(got.prediction[:, :frame], first.prediction[:, :frame])


def test_pred_is_int32():
    emb, seeds = make_inputs(2, 5, 6, 8, 3, seed=7)
    cfg = LabelPropConfig(4, 3, 0.1, 4)
    _, pred = propagate_labels(emb[0], seeds[0], cfg, device="cpu")
    _, pred_b = propagate_labels_batched(emb, seeds, cfg, device="cpu")
    assert pred.dtype == pred_b.dtype == torch.int32
    mask = torch.as_tensor(radius_mask(6, 1, 3))
    soft = propagate_seq_reference(torch.as_tensor(emb), torch.as_tensor(seeds), mask, (0,), 4,
                                   0.1, 4)
    assert torch.equal(pred_b, soft.argmax(-1).to(torch.int32))
