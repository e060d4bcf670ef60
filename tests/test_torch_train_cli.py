"""The port's CRW training entry point (radar_sounder_crw_tpu_torch/cli/
train.py) vs the JAX package's script (scripts/train.py), in-process on the
CPU at tests/test_script_smokes.py's flags (the MCORDS1 fixture); the port
runs with --device cpu. tests/test_torch_unet_cli.py does the same for
cli/test_unet.py.

The two sides start from their own random inits (flax's and the port's
seeded torch init), so the checks are the contract of the entry point: the
printed lines, the files written, the encoder `.pt`'s keys and shapes equal
to the script's, and a --ckpt_dir run followed by --resume continuing the
step count. Values are held to the JAX package by the trainer tests
(tests/test_torch_train.py, tests/test_torch_unet.py).
"""

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import torch

from radar_sounder_crw_tpu.data import load_pt as jax_load_pt
from radar_sounder_crw_tpu_torch.cli import train as port_train
from radar_sounder_crw_tpu_torch.data import load_pt
from radar_sounder_crw_tpu_torch.train import CheckpointManager
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
FIXTURE_ROOT = os.path.join(REPO, "tests", "fixtures", "data_root")
TRAIN_FLAGS = ["--model", "0", "--dataset", "0", "--patch_size", "16", "16", "--overlap", "0",
               "0", "--seq_length", "4", "--batch_size", "4", "--epochs", "1"]


def jax_script(name):
    """scripts/<name>.py as a module (its `_common` import needs scripts/ on
    the path)."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    key = f"_jax_script_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def run(module, argv):
    """main() of a CLI module on its own parser; (stdout, main's result)."""
    args = module.get_args_parser().parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.main(args)
    return out.getvalue(), result


def test_train_matches_the_script(tmp_path, monkeypatch):
    monkeypatch.setenv("RSCRW_DATA_ROOT", FIXTURE_ROOT)
    outs = {}
    for side, module, extra in (("jax", jax_script("train"), []),
                                ("port", port_train, ["--device", "cpu"])):
        folder = str(tmp_path / side)
        text, _ = run(module, [*TRAIN_FLAGS, "--output_folder", folder, "--output_name", "smoke",
                               *extra])
        lines = text.splitlines()
        assert "Finished training." in lines, text
        assert any(ln.startswith("Number of trainable parameters: ") for ln in lines), text
        assert any(ln.startswith("Epoch: 0 Loss: ") for ln in lines), text
        pt = os.path.join(folder, "models", "smoke.pt")
        assert f"Saved encoder to {pt}" in lines
        assert os.path.exists(os.path.join(folder, "output", "_loss.png"))
        outs[side] = (pt, [ln for ln in lines if ln.startswith("Number of")])
    assert outs["port"][1] == outs["jax"][1]  # parameter counts
    want = jax_load_pt(outs["jax"][0])
    got = load_pt(outs["port"][0])
    assert {k: tuple(np.shape(v)) for k, v in got.items()} == {
        k: tuple(np.shape(v)) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())


def test_train_resume_continues_the_step_count(tmp_path, monkeypatch):
    monkeypatch.setenv("RSCRW_DATA_ROOT", FIXTURE_ROOT)
    ckpt = str(tmp_path / "ckpt")
    argv = [*TRAIN_FLAGS, "--output_folder", str(tmp_path / "out"), "--device", "cpu",
            "--ckpt_dir", ckpt, "--no_plots"]
    _, first = run(port_train, argv)
    steps = first.step
    assert steps > 0 and CheckpointManager(ckpt).latest_step() == steps
    assert not os.path.exists(tmp_path / "out" / "output" / "_loss.png")
    text, resumed = run(port_train, [*argv, "--resume"])
    assert f"Resumed from step {steps}" in text.splitlines()
    assert resumed.step == 2 * steps and resumed._epoch_idx == 2
    assert CheckpointManager(ckpt).latest_step() == 2 * steps
