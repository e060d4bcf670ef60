"""`.pt` interchange and encoder checkpoints of the port vs the JAX package
(CPU).

* `data.save_pt` / `data.load_pt`: a file written by either package loads on
  the other with equal values and dtypes; an int8 map stays int8; a file
  that needs full unpickling is refused unless RSCRW_ALLOW_UNSAFE_PT=1.
* `models.load_torch_checkpoint`: an encoder file in the reference layout,
  written from JAX weights (`export_state_dict`), with and without the
  `module.` prefix and with and without BatchNorm buffers, loads strictly
  into `create_model` and encodes to 1e-5 of the JAX encoder with the same
  weights (the JAX CLIs fill missing BatchNorm statistics from a fresh init:
  mean 0, variance 1).
(The name `tests/test_torch_pt.py` is taken by a test of the JAX package's
reader.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu.data import load_pt as jax_load_pt
from radar_sounder_crw_tpu.data import save_pt as jax_save_pt
from radar_sounder_crw_tpu.infer.propagate import encode_sequence as jax_encode
from radar_sounder_crw_tpu.models import load_torch_checkpoint as jax_load_checkpoint
from radar_sounder_crw_tpu.models.torch_import import export_state_dict
from radar_sounder_crw_tpu_torch.data import load_pt, save_pt
from radar_sounder_crw_tpu_torch.infer.propagate import encode_sequence
from radar_sounder_crw_tpu_torch.models import create_model, load_torch_checkpoint
from radar_sounder_crw_tpu_torch.models import read_state_dict
from test_torch_encoders import jax_and_torch_models

ENC_ATOL = 1e-5


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "map": rng.integers(0, 6, (32, 48)).astype(np.int8),
        "rg": rng.standard_normal((16, 40)).astype(np.float32),
        "idx": np.arange(7, dtype=np.int64),
        "u8": rng.integers(0, 255, (5, 3)).astype(np.uint8),
        "f64": rng.random(4),
    }


def test_port_file_loads_on_jax(tmp_path):
    arrays = _arrays()
    save_pt(tmp_path / "a.pt", arrays)
    got = jax_load_pt(tmp_path / "a.pt")
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_jax_file_loads_on_the_port(tmp_path):
    arrays = _arrays()
    jax_save_pt(tmp_path / "a.pt", arrays)
    got = load_pt(tmp_path / "a.pt")
    for k, v in arrays.items():
        assert isinstance(got[k], torch.Tensor) and np.array_equal(got[k].numpy(), v), k
        assert got[k].numpy().dtype == v.dtype, k


def test_int8_map_round_trips(tmp_path):
    m = np.random.default_rng(1).integers(0, 6, (64, 960)).astype(np.int8)
    save_pt(tmp_path / "map.pt", m)
    back = load_pt(tmp_path / "map.pt")
    assert back.dtype == torch.int8 and np.array_equal(back.numpy(), m)
    assert (tmp_path / "map.pt").stat().st_size < 2 * m.nbytes  # one byte a pixel
    save_pt(tmp_path / "t.pt", [torch.from_numpy(m), (m[:2],)])
    lst = load_pt(tmp_path / "t.pt")
    assert lst[0].dtype == torch.int8 and lst[1][0].dtype == torch.int8


def test_full_unpickling_needs_the_opt_in(tmp_path, monkeypatch):
    model = create_model(0, False, device="cpu")
    torch.save(model, tmp_path / "module.pt")
    monkeypatch.delenv("RSCRW_ALLOW_UNSAFE_PT", raising=False)
    with pytest.raises(ValueError, match="RSCRW_ALLOW_UNSAFE_PT"):
        load_pt(tmp_path / "module.pt")
    monkeypatch.setenv("RSCRW_ALLOW_UNSAFE_PT", "1")
    sd = read_state_dict(tmp_path / "module.pt")  # a pickled nn.Module gives its state_dict
    assert sd.keys() == model.state_dict().keys()
    fresh = load_torch_checkpoint(tmp_path / "module.pt", create_model(0, False, device="cpu",
                                                                       seed=5))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def _fresh_stats(node):
    """The BatchNorm statistics the JAX CLIs give a file without them (a
    fresh init's): mean 0, variance 1."""
    if set(node) == {"mean", "var"}:
        return {"mean": np.zeros_like(node["mean"]), "var": np.ones_like(node["var"])}
    return {k: _fresh_stats(v) for k, v in node.items()}


@pytest.mark.parametrize("model_id", [0, 1])
@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("buffers", [True, False])
def test_checkpoint_from_jax_weights_encodes_like_jax(tmp_path, model_id, prefix, buffers):
    jmodel, variables, _ = jax_and_torch_models(model_id, False)
    sd = export_state_dict(variables)
    if not buffers:
        sd = {k: v for k, v in sd.items() if not k.endswith(("running_mean", "running_var"))}
    path = tmp_path / "enc.pt"
    jax_save_pt(path, {prefix + k: v for k, v in sd.items()})
    model = load_torch_checkpoint(path, create_model(model_id, False, device="cpu", seed=3))
    want_vars = variables
    if not buffers and "batch_stats" in variables:
        want_vars = {"params": variables["params"],
                     "batch_stats": _fresh_stats(variables["batch_stats"])}
    if buffers:  # the JAX loader reads the same file into the same parameters (it
        # tells BatchNorm layers by their running statistics, so it needs them)
        jloaded = jax.tree_util.tree_leaves(jax_load_checkpoint(str(path))["params"])
        for a, b in zip(jloaded, jax.tree_util.tree_leaves(variables["params"]), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    seq = np.random.default_rng(model_id).standard_normal((3, 5, 16, 16)).astype(np.float32)
    want = np.asarray(jax_encode(jmodel, want_vars, jnp.asarray(seq), False, False))
    got = encode_sequence(model, torch.as_tensor(seq), False, False).numpy()
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=0)


def test_checkpoint_strictness(tmp_path):
    _, variables, tmodel = jax_and_torch_models(1, False)
    sd = export_state_dict(variables)
    missing = {k: v for k, v in sd.items() if k != "model.fc.bias"}
    jax_save_pt(tmp_path / "missing.pt", missing)
    with pytest.raises(RuntimeError, match="model.fc.bias"):
        load_torch_checkpoint(tmp_path / "missing.pt", create_model(1, False, device="cpu"))
    jax_save_pt(tmp_path / "extra.pt", {**sd, "head.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="head.weight"):
        load_torch_checkpoint(tmp_path / "extra.pt", create_model(1, False, device="cpu"))
    jax_save_pt(tmp_path / "list.pt", [np.zeros(3, np.float32)])
    with pytest.raises(ValueError, match="state_dict"):
        load_torch_checkpoint(tmp_path / "list.pt", create_model(1, False, device="cpu"))
    # the port's own state_dict (with num_batches_tracked) round-trips too
    save_pt(tmp_path / "port.pt", tmodel.state_dict())
    back = load_torch_checkpoint(tmp_path / "port.pt", create_model(1, False, device="cpu"))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
