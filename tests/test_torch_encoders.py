"""PyTorch port encoders vs the flax encoders on shared weights (CPU).

The JAX weights come from `create_model(...).init`, with the BatchNorm
running statistics replaced by seeded random ones so eval BN is not the
identity; they cross to torch through `state_dict_from_jax` and load with
strict=True. Tolerance: atol 1e-4 on the 128-d outputs and embeddings
(different conv summation orders on the two sides; float32 throughout).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.infer.propagate import encode_sequence as jax_encode
from radar_sounder_crw_tpu.models import create_model as jax_create_model
from radar_sounder_crw_tpu_torch.infer.propagate import encode_sequence
from radar_sounder_crw_tpu_torch.models import (
    create_model,
    param_count,
    state_dict_from_jax,
)

HW = (16, 16)
ATOL = 1e-4


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _flax_init(model_id, pos_embed, hw):
    jmodel = jax_create_model(model_id, pos_embed)
    in_ch = 2 if pos_embed else 1
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, in_ch)), train=False)
    return jmodel, _numpy_tree(variables)


def jax_and_torch_models(model_id, pos_embed, hw=HW, seed=0):
    """(flax model, flax variables, torch model on CPU) with equal weights."""
    jmodel, variables = _flax_init(model_id, pos_embed, hw)
    variables = _numpy_tree(variables)  # fresh dicts: randomize() below edits them
    rng = np.random.default_rng(seed)

    def randomize(node):
        for k, v in node.items():
            if isinstance(v, dict):
                randomize(v)
            elif k == "mean":
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    if "batch_stats" in variables:
        randomize(variables["batch_stats"])
    tmodel = create_model(model_id, pos_embed, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("model_id,expected", [(0, 263_088), (1, 4_971_468)])
def test_param_counts_match(model_id, expected):
    jmodel, variables, tmodel = jax_and_torch_models(model_id, False)
    jax_count = sum(np.size(p) for p in jax.tree_util.tree_leaves(variables["params"]))
    assert jax_count == expected
    assert param_count(tmodel) == expected


@pytest.mark.parametrize("model_id", [0, 1])
@pytest.mark.parametrize("pos_embed", [False, True])
def test_forward_matches_flax_eval(model_id, pos_embed):
    jmodel, variables, tmodel = jax_and_torch_models(model_id, pos_embed)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, *HW, 2 if pos_embed else 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert got.shape == want.shape == (6, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "model_id,pos_embed,bn_train_mode",
    [(1, False, False), (1, True, False), (1, False, True), (0, True, False)],
)
def test_encode_sequence_matches(model_id, pos_embed, bn_train_mode):
    jmodel, variables, tmodel = jax_and_torch_models(model_id, pos_embed)
    rng = np.random.default_rng(2)
    seq = rng.standard_normal((3, 5, *HW)).astype(np.float32)
    want = np.asarray(jax_encode(jmodel, variables, jnp.asarray(seq), pos_embed, bn_train_mode))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    got = encode_sequence(tmodel, torch.from_numpy(seq), pos_embed, bn_train_mode).numpy()
    assert got.shape == want.shape == (3, 5, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    # batch-statistics mode must not touch the running statistics or mode
    after = tmodel.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not tmodel.training


def test_state_dict_names_are_reference_names():
    _, variables, _ = jax_and_torch_models(1, False)
    sd = state_dict_from_jax(variables)
    for name in ("fc0.weight", "bn0.running_var", "model.conv1.weight",
                 "model.layer2.0.downsample.0.weight",
                 "model.layer2.0.downsample.1.running_mean", "model.fc.weight"):
        assert name in sd, name
    assert tuple(sd["model.conv1.weight"].shape) == (64, 3, 7, 7)  # OIHW
    assert tuple(sd["model.fc.weight"].shape) == (128, 512)  # (out, in)


def test_create_model_init_is_seeded_and_torch_default():
    a = create_model(1, False, device="cpu", seed=3)
    b = create_model(1, False, device="cpu", seed=3)
    c = create_model(1, False, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["model.conv1.weight"], sc["model.conv1.weight"])
    # kaiming-normal fan-out on the core convs: std = sqrt(2 / fan_out)
    w = sa["model.layer3.0.conv2.weight"]
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() / np.sqrt(2.0 / fan_out) - 1) < 0.05
    # torch default uniform elsewhere: |w| <= 1/sqrt(fan_in)
    assert sa["fc0.weight"].abs().max() <= 1.0 + 1e-6  # fan_in 1
    assert sa["model.fc.weight"].abs().max() <= 1 / np.sqrt(512) + 1e-6
    assert not a.training
