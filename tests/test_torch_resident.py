"""The plain twin of the resident kernel vs the JAX resident kernel (CPU).

`propagate_all_reference` (ops/labelprop.py, the twin `csrc/prop_all.cu` is
held against bit for bit on the card) against the Pallas `_prop_all_kernel`
in interpret mode, through the JAX `propagate_labels(_batched)(kernel=
'pallas_resident_interpret')` and `PropagationPipeline(kernel=...)`. Soft
labels to rtol 1e-4 / atol 1e-6 (CPU products sum in other orders on the
two sides), argmax maps exactly equal. Against the port's other twin
(`propagate_seq_reference`, another summation order of the same weights)
soft labels agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.infer import PropagationPipeline as JaxPipeline
from radar_sounder_crw_tpu.ops.labelprop import LabelPropConfig as JaxConfig
from radar_sounder_crw_tpu.ops.labelprop import propagate_labels as jax_propagate
from radar_sounder_crw_tpu.ops.labelprop import propagate_labels_batched as jax_batched
from radar_sounder_crw_tpu_torch.data import RGWindows, synthetic_radargram
from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
from radar_sounder_crw_tpu_torch.infer import propagate as port_propagate
from radar_sounder_crw_tpu_torch.infer.propagate import (
    encode_sequence,
    seed_onehot_from_segmentation,
)
from radar_sounder_crw_tpu_torch.ops import labelprop, labelprop_cuda
from radar_sounder_crw_tpu_torch.ops.labelprop import (
    LabelPropConfig,
    propagate_all_reference,
    propagate_seq_reference,
    radius_mask,
    resolve_kernel,
)
from test_torch_encoders import jax_and_torch_models

RTOL, ATOL = 1e-4, 1e-6
TEMP = 0.07


def make_inputs(B, T, N, C, M, seed, ties=False, soft_seeds=False):
    """emb (B, T, N, C) L2-normalized (dyadic halves with ties=True: exact
    dot products, real ties) and one-hot seeds (random soft labels with
    soft_seeds=True, so no two classes tie exactly)."""
    rng = np.random.default_rng(seed)
    if ties:
        emb = rng.integers(-2, 3, (B, T, N, C)).astype(np.float32) / 2
    else:
        emb = rng.standard_normal((B, T, N, C)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    if soft_seeds:
        seeds = rng.random((B, N, M)).astype(np.float32)
    else:
        seeds = np.eye(M, dtype=np.float32)[rng.integers(0, M, (B, N))]
    return emb, seeds


def twin(emb, seeds, cxt, radius, temperature, knn, long_mem):
    """The twin on numpy inputs, with knn clipped as the entry points clip it."""
    N = emb.shape[2]
    mask = torch.from_numpy(radius_mask(N, 1, radius))
    knn = min(knn, (len(long_mem) + cxt) * N)
    return propagate_all_reference(torch.from_numpy(emb), torch.from_numpy(seeds), mask,
                                   long_mem, cxt, temperature, knn)


def assert_matches(soft, want_soft, want_pred=None):
    want_soft = np.asarray(want_soft)
    assert soft.shape == want_soft.shape
    np.testing.assert_allclose(soft.numpy(), want_soft, rtol=RTOL, atol=ATOL)
    want_pred = want_soft.argmax(-1) if want_pred is None else np.asarray(want_pred)
    np.testing.assert_array_equal(soft.argmax(-1).numpy(), want_pred)


# (a) the shapes of tests/test_labelprop.py::test_resident_kernel_matches_xla
@pytest.mark.parametrize("long_mem", [(0,), (0, 2, 5), ()])
def test_twin_matches_jax_resident_interpret(long_mem):
    emb, seeds = make_inputs(1, 12, 10, 8, 4, seed=31)
    cfg = JaxConfig(cxt_size=4, radius=4, temperature=TEMP, knn=5, long_mem=long_mem)
    want, want_pred = jax_propagate(jnp.asarray(emb[0]), jnp.asarray(seeds[0]), cfg, None,
                                    "pallas_resident_interpret")
    soft = twin(emb, seeds, 4, 4, TEMP, 5, long_mem)
    assert_matches(soft[0], want, want_pred)
    # the kernel wrapper on CPU tensors is the twin, bit for bit, and launches nothing
    mask = torch.from_numpy(radius_mask(10, 1, 4))
    before = labelprop_cuda.launches["prop_all"]
    via_wrapper = labelprop_cuda.prop_all(torch.from_numpy(emb), torch.from_numpy(seeds), mask,
                                          long_mem, 4, TEMP, 5)
    assert labelprop_cuda.launches["prop_all"] == before
    assert torch.equal(via_wrapper, soft)


# (b) the shapes of tests/test_labelprop.py::test_resident_kernel_vmap_matches_per_item
def test_batched_twin_matches_jax_vmapped_resident_kernel():
    emb, seeds = make_inputs(3, 8, 10, 8, 4, seed=40)
    cfg = JaxConfig(cxt_size=4, radius=4, temperature=TEMP, knn=4)
    want, want_pred = jax_batched(jnp.asarray(emb), jnp.asarray(seeds), cfg, None,
                                  "pallas_resident_interpret")
    soft = twin(emb, seeds, 4, 4, TEMP, 4, (0,))
    assert_matches(soft, want, want_pred)
    # each radargram alone is the same, bit for bit
    for r in range(3):
        assert torch.equal(twin(emb[r : r + 1], seeds[r : r + 1], 4, 4, TEMP, 4, (0,))[0], soft[r])


# (c) tests/test_labelprop_pallas.py::test_resident_kernel_single_frame_returns_seed
def test_single_frame_returns_the_seed():
    emb, seeds = make_inputs(1, 1, 6, 8, 3, seed=17)
    cfg = JaxConfig(cxt_size=4, radius=3, temperature=0.1, knn=3)
    want, _ = jax_propagate(jnp.asarray(emb[0]), jnp.asarray(seeds[0]), cfg, None,
                            "pallas_resident_interpret")
    soft = twin(emb, seeds, 4, 3, 0.1, 3, (0,))
    np.testing.assert_array_equal(soft[0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(soft.numpy(), seeds[:, None])


# (d) dyadic ties: the lowest candidate wins on both sides
@pytest.mark.parametrize("long_mem", [(0,), (0, 3)])
def test_dyadic_ties_maps_equal_jax(long_mem):
    emb, seeds = make_inputs(1, 10, 14, 8, 4, seed=7, ties=True, soft_seeds=True)
    cfg = JaxConfig(cxt_size=4, radius=3, temperature=TEMP, knn=5, long_mem=long_mem)
    want, want_pred = jax_propagate(jnp.asarray(emb[0]), jnp.asarray(seeds[0]), cfg, None,
                                    "pallas_resident_interpret")
    assert_matches(twin(emb, seeds, 4, 3, TEMP, 5, long_mem)[0], want, want_pred)


# (e) knn above the K*N candidates
def test_knn_above_the_candidate_count():
    emb, seeds = make_inputs(1, 6, 5, 8, 3, seed=9)
    cfg = JaxConfig(cxt_size=2, radius=3, temperature=TEMP, knn=40)
    want, want_pred = jax_propagate(jnp.asarray(emb[0]), jnp.asarray(seeds[0]), cfg, None,
                                    "pallas_resident_interpret")
    soft = twin(emb, seeds, 2, 3, TEMP, 40, (0,))
    assert_matches(soft[0], want, want_pred)
    # unclipped, the extra winners (none in the prefix) change nothing
    mask = torch.from_numpy(radius_mask(5, 1, 3))
    unclipped = propagate_all_reference(torch.from_numpy(emb), torch.from_numpy(seeds), mask,
                                        (0,), 2, TEMP, 40)
    assert torch.equal(unclipped, soft)


# (f) the port's two twins: one selection, two summation orders
def test_twin_agrees_with_the_seq_twin():
    emb, seeds = make_inputs(3, 10, 12, 8, 4, seed=21, soft_seeds=True)
    mask = torch.from_numpy(radius_mask(12, 1, 4))
    e, s = torch.from_numpy(emb), torch.from_numpy(seeds)
    resident = propagate_all_reference(e, s, mask, (0, 2), 4, TEMP, 5)
    seq = propagate_seq_reference(e, s, mask, (0, 2), 4, TEMP, 5)
    top2 = torch.sort(seq, dim=-1).values[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min().item() > 1e-5, "fixture lost its margins"
    assert (resident - seq).abs().max().item() <= 1e-5
    assert torch.equal(resident.argmax(-1), seq.argmax(-1))
    assert torch.equal(resident[:, 0], s)


# (g) the slice on shared weights ---------------------------------------------

T_WIN, NCLS = 8, 4
MARGIN = dict(cxt_size=10, radius=1.5, temperature=0.1, knn=40)  # no knn boundary


@pytest.fixture(scope="module")
def survey():
    rg, seg = synthetic_radargram(H=72, W=800, nclasses=NCLS, seed=3)
    ds = RGWindows(rg, length=T_WIN, dim=(16, 16), overlap=(8, 0))
    ids = list(range(0, len(ds), T_WIN))[:3]
    geo = ds.geo
    refs = [seg[: geo.rg_h(), geo.col_start(i) : geo.col_start(i) + 16] for i in ids]
    jmodel, variables, tmodel = jax_and_torch_models(0, False)
    jp = JaxPipeline(jmodel, variables, JaxConfig(**MARGIN), nclasses=NCLS,
                     kernel="pallas_resident_interpret")
    return ds, ids, refs, jp, tmodel


def test_slice_map_equals_jax_resident_pipeline(survey):
    """Encoder embeddings of the port through the prop_all wrapper on CPU
    tensors (the twin) give the JAX resident pipeline's map."""
    ds, ids, refs, jp, tmodel = survey
    seq = ds[ids[0]]
    want = jp(seq, refs[0], return_soft=True)
    top2 = np.sort(want.soft, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4, "fixture lost its margins"
    emb = encode_sequence(tmodel, torch.from_numpy(seq), False, False)
    N = emb.shape[1]
    seed, _ = seed_onehot_from_segmentation(refs[0], N, NCLS)
    mask = torch.from_numpy(radius_mask(N, 1, MARGIN["radius"]))
    soft = labelprop_cuda.prop_all(emb[None], torch.from_numpy(seed)[None], mask, (0,),
                                   MARGIN["cxt_size"], MARGIN["temperature"],
                                   min(MARGIN["knn"], (1 + MARGIN["cxt_size"]) * N))
    np.testing.assert_array_equal(soft[0].argmax(-1).T.numpy(), want.prediction)
    np.testing.assert_allclose(soft[0].numpy(), want.soft, rtol=0, atol=1e-4)


def test_pipeline_paths_reach_prop_all_once_each(survey, monkeypatch):
    """PropagationPipeline(kernel='cuda_resident') with the device check
    lifted, on CPU tensors: seed->map, reseed and a survey pass each reach
    the prop_all wrapper once and give the JAX resident pipeline's maps."""
    ds, ids, refs, jp, tmodel = survey
    calls = []
    for mod in (labelprop, port_propagate):
        monkeypatch.setattr(mod, "resolve_kernel", lambda kernel, device: kernel)
    monkeypatch.setattr(labelprop_cuda, "prop_all",
                        lambda *a: calls.append(a[0].shape[0]) or propagate_all_reference(*a))
    tp = PropagationPipeline(tmodel, LabelPropConfig(**MARGIN), NCLS, kernel="cuda_resident",
                             device="cpu")
    seq = ds[ids[0]]
    np.testing.assert_array_equal(tp(seq, refs[0]).prediction, jp(seq, refs[0]).prediction)
    np.testing.assert_array_equal(tp.reseed(refs[1], 3).prediction,
                                  jp.reseed(refs[1], 3).prediction)
    got = tp.propagate_survey(ds, ids, refs)
    np.testing.assert_array_equal(got, jp.propagate_batch(np.stack([ds[i] for i in ids]), refs))
    assert calls == [1, 1, len(ids)]


# (h) routing ------------------------------------------------------------------


def test_resolve_kernel_names_cuda_resident_only_on_cuda():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        resolve_kernel("cuda_resident", cpu)
    assert resolve_kernel("cuda_resident", cuda) == "cuda_resident"
    # one radargram and a batch alike: the whole-sequence kernel on the card
    assert {resolve_kernel("auto", d) for d in (cpu, cuda)} == {"torch", "cuda_seq"}
    emb, seeds = make_inputs(1, 3, 4, 8, 2, seed=1)
    with pytest.raises(ValueError, match="CUDA device"):
        labelprop.propagate_labels(emb[0], seeds[0], LabelPropConfig(), kernel="cuda_resident",
                                   device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        PropagationPipeline(jax_and_torch_models(0, False)[2], LabelPropConfig(), 2,
                            kernel="cuda_resident", device="cpu")
