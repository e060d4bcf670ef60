"""The port's inference entry points (radar_sounder_crw_tpu_torch/cli/) vs the
JAX package's scripts (CPU).

Both sides run in-process, the JAX script loaded from scripts/ the way
tests/test_annotate_server.py loads scripts/annotate.py, with the same flags
and one shared encoder checkpoint the test writes from JAX weights
(`export_state_dict`); the port runs with --device cpu. Rules, as in
ROADMAP.md: on the margin config (radius 2, knn above the candidate count)
the maps are equal; on the generic config >= 99.5 % of the map is equal
(the encoders differ by ~1e-6 and a top-k boundary that close may flip);
change indices are equal; the printed reports are equal wherever the maps
are. Change detection is pinned to one schedule on both sides where a test
needs the correction passes to run (random weights flag no change on these
small inputs), as tests/test_script_batched_phases.py pins it.
"""

import contextlib
import importlib
import importlib.util
import itertools
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import radar_sounder_crw_tpu.infer.propagate as jax_propagate_mod
import radar_sounder_crw_tpu_torch.infer.propagate as port_propagate_mod
from radar_sounder_crw_tpu.data import load_pt as jax_load_pt
from radar_sounder_crw_tpu.data import registry as jax_registry
from radar_sounder_crw_tpu.data import save_pt as jax_save_pt
from radar_sounder_crw_tpu.models.torch_import import export_state_dict
from radar_sounder_crw_tpu_torch.cli import _common
from radar_sounder_crw_tpu_torch.data import load_pt, synthetic_radargram
from radar_sounder_crw_tpu_torch.data import registry
from test_torch_encoders import jax_and_torch_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
FIXTURE_ROOT = os.path.join(REPO, "tests", "fixtures", "data_root")
AGREEMENT = 0.995
GENERIC = ["-c", "4", "-r", "4", "-t", "0.1", "-k", "3"]
MARGIN = ["-c", "8", "-r", "2", "-t", "0.1", "-k", "100"]
CLIS = ("test", "test_all", "test_mc1", "test_mc3", "test_sharad", "annotate", "heatmap",
        "show_grid")


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


def port_cli(name):
    return importlib.import_module(f"radar_sounder_crw_tpu_torch.cli.{name}")


def _write_checkpoint(tmp_path_factory, model_id):
    """An encoder file in the reference layout, from JAX weights (BatchNorm
    statistics randomized, so eval BatchNorm is not the identity)."""
    _, variables, _ = jax_and_torch_models(model_id, False)
    path = tmp_path_factory.mktemp("ckpt") / f"encoder{model_id}.pt"
    jax_save_pt(path, export_state_dict(variables))
    return str(path)


@pytest.fixture(scope="session")
def checkpoint(tmp_path_factory):
    """The CNN (model 0), for the entry points with a --model flag."""
    return _write_checkpoint(tmp_path_factory, 0)


@pytest.fixture(scope="session")
def resnet_checkpoint(tmp_path_factory):
    """The ResNet-10 (model 1), which the qualitative entry points load."""
    return _write_checkpoint(tmp_path_factory, 1)


def run_both(capsys, name, args, tmp_path, jax_args=()):
    """Run scripts/<name>.py and the port's cli.<name> on the same flags, the
    JAX script with `jax_args` besides (its --batched form); returns
    {side: (main's result, its stdout)}, outputs under tmp_path/side."""
    out = {}
    for side, mod, extra in (("jax", jax_script(name), [*jax_args]),
                             ("port", port_cli(name), ["--device", "cpu"])):
        argv = [*args, *extra]
        if "--output_folder" not in args:
            argv += ["--output_folder", str(tmp_path / side)]
        capsys.readouterr()
        result = mod.main(mod.get_args_parser().parse_args(argv))
        out[side] = (result, capsys.readouterr().out)
    return out


def pin_changes(monkeypatch, schedule):
    """Both packages' change detection returns `schedule`, radargram after
    radargram, restarting for each side's run."""
    for mod in (jax_propagate_mod, port_propagate_mod):
        cycler = itertools.cycle(schedule)
        monkeypatch.setattr(mod, "detect_change_point",
                            lambda sig, pen=5.0, _c=cycler: next(_c))


def lines(text, *prefixes):
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


def report(text):
    """From 'Computing reports' through the 'mIoU:' line."""
    ls = text.splitlines()
    i = next(k for k, ln in enumerate(ls) if ln.startswith("Computing reports"))
    j = next(k for k, ln in enumerate(ls) if ln.startswith("mIoU:"))
    return "\n".join(ls[i : j + 1])


def assert_maps(got, want, margin):
    assert got.shape == want.shape
    agree = float((got == want).mean())
    if margin:
        assert agree == 1.0
    assert agree >= AGREEMENT, agree
    return agree == 1.0


# -- test_all -------------------------------------------------------------------


@pytest.mark.parametrize(
    "config,mode,schedule",
    [
        ("generic", ["--batched"], None),  # change points from PELT on both sides
        ("generic", [], [3, None, 5, 3, 8]),
        ("generic", ["--batched"], [3, None, 5, 3, 8]),
        ("generic", ["--batched", "--correction_tail"], [3, None, 5, 3, 8]),
        ("margin", ["--correction_tail"], [2, 6, None, 6, 9]),
        ("margin", ["--batched", "--correction_tail"], [2, 6, None, 6, 9]),
    ],
)
def test_test_all_matches_jax_on_the_fixture(capsys, monkeypatch, tmp_path, checkpoint, config,
                                             mode, schedule):
    """The committed MCoRDS1 fixture (dataset 0): forward, corrections (head
    or tail, bucketed), reverse with the dataset-0 merge and the
    uncertain-class removal from reference 2; the port's one form against
    the JAX script's per-radargram loop and its --batched form (`mode`'s
    --batched goes to the JAX side alone)."""
    monkeypatch.setenv("RSCRW_DATA_ROOT", FIXTURE_ROOT)
    if schedule is not None:
        pin_changes(monkeypatch, schedule)
    batched = "--batched" in mode
    args = ["--model", "0", "--dataset", "0", "--patch_size", "16", "16", "--overlap", "8", "0",
            "--seq_length", "12", *(GENERIC if config == "generic" else MARGIN),
            "--dataset_full", "0", "--no_plots", "--correction", "--use_last",
            "--model_path", checkpoint, *(m for m in mode if m != "--batched")]
    out = run_both(capsys, "test_all", args, tmp_path, ["--batched"] if batched else [])
    (want, jtxt), (got, ptxt) = out["jax"], out["port"]
    assert "using synthetic" not in ptxt and "Loaded encoder weights" in ptxt
    assert lines(ptxt, "Change point for each") == lines(jtxt, "Change point for each")
    if batched:
        assert lines(ptxt, "Correction batch") == lines(jtxt, "Correction batch")
    if schedule is not None:
        assert "None, 5" in lines(ptxt, "Change point for each")[0] or config == "margin"
    if assert_maps(got, want, config == "margin"):
        assert report(ptxt) == report(jtxt)
    # the int8 map, .npy and .pt; each package's .pt loads on the other
    npy = np.load(tmp_path / "port" / "predicted_map.npy")
    assert npy.dtype == np.int8 and np.array_equal(npy, got.astype(np.int8))
    assert np.array_equal(jax_load_pt(tmp_path / "port" / "predicted_map.pt"), npy)
    jax_pt = load_pt(tmp_path / "jax" / "predicted_map.pt")
    assert jax_pt.dtype == torch.int8
    assert np.array_equal(jax_pt.numpy(), np.load(tmp_path / "jax" / "predicted_map.npy"))


@pytest.fixture
def small_miguel(monkeypatch):
    """A shallow full-width Miguel line planted in both registries' caches
    (the trim offsets are absolute, so the width stays 105120)."""
    monkeypatch.setenv("RSCRW_DATA_ROOT", "/nonexistent-rscrw-root")
    monkeypatch.setenv("RSCRW_SYNTH_SCALE", "8")
    pair = synthetic_radargram(H=32, W=105120, nclasses=6, seed=11)
    monkeypatch.setitem(registry._synth_cache, (1, 8), pair)
    monkeypatch.setitem(jax_registry._synth_cache, (1, 8), pair)


@pytest.mark.parametrize("dataset,batched", [
    pytest.param(1, True, id="1"), pytest.param(3, True, id="3"),
    pytest.param(1, False, id="1-sequential"), pytest.param(3, False, id="3-sequential")])
def test_test_all_datasets_match_jax(capsys, monkeypatch, tmp_path, checkpoint, small_miguel,
                                     dataset, batched):
    """Synthetic Miguel (dataset 1: the trim, the MCORDS3 merge, removal of
    label 5) and SHARAD (dataset 3: the bedrock merge on the second half),
    corrections bucketed, against the JAX script's --batched form and its
    per-radargram loop."""
    pin_changes(monkeypatch, [4, None, 2, 4])
    geometry = (["--patch_size", "16", "16", "--overlap", "0", "0", "--seq_length", "40"]
                if dataset == 1 else
                ["--patch_size", "16", "16", "--overlap", "8", "0", "--seq_length", "6"])
    args = ["--model", "0", "--dataset", str(dataset), *geometry, *GENERIC,
            "--dataset_full", "0", "--no_plots", "--correction", "--use_last",
            "--model_path", checkpoint]
    out = run_both(capsys, "test_all", args, tmp_path, ["--batched"] if batched else [])
    (want, jtxt), (got, ptxt) = out["jax"], out["port"]
    assert lines(ptxt, "Num of radargrams") == lines(jtxt, "Num of radargrams")
    assert lines(ptxt, "Change point for each") == lines(jtxt, "Change point for each")
    if batched:
        assert lines(ptxt, "Correction batch") == lines(jtxt, "Correction batch")
    if assert_maps(got, want, margin=False):
        assert report(ptxt) == report(jtxt)


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
@pytest.mark.parametrize("extra", [
    ["--flip", "--dataset_full", "0", "--correction", "--use_last"],
    ["--correction", "--use_last"],
    ["--dataset_full", "0", "--correction"],
], ids=["flip", "full", "correction_only"])
def test_test_all_options_match_jax(capsys, monkeypatch, tmp_path, checkpoint, extra, batched):
    """The committed MCoRDS1 fixture with the radargram flipped (--flip),
    every stride-seq_length window of the dataset (--dataset_full 1, the
    default), and corrections without the reverse pass: the port's one form
    against the JAX script's per-radargram loop and its --batched form."""
    monkeypatch.setenv("RSCRW_DATA_ROOT", FIXTURE_ROOT)
    pin_changes(monkeypatch, [3, None, 5, 3, 8])
    args = ["--model", "0", "--dataset", "0", "--patch_size", "16", "16", "--overlap", "8", "0",
            "--seq_length", "12", *GENERIC, "--no_plots", "--model_path", checkpoint, *extra]
    out = run_both(capsys, "test_all", args, tmp_path, ["--batched"] if batched else [])
    (want, jtxt), (got, ptxt) = out["jax"], out["port"]
    assert lines(ptxt, "List of items") == lines(jtxt, "List of items")
    assert lines(ptxt, "Change point for each") == lines(jtxt, "Change point for each")
    assert ("Reversed step" in ptxt) == ("--use_last" in extra)
    if batched:
        assert lines(ptxt, "Correction batch") == lines(jtxt, "Correction batch")
    if assert_maps(got, want, margin=False):
        assert report(ptxt) == report(jtxt)


# -- test -------------------------------------------------------------------------


def test_test_cli_matches_jax(capsys, monkeypatch, tmp_path, checkpoint):
    monkeypatch.setenv("RSCRW_DATA_ROOT", "/nonexistent-rscrw-root")
    monkeypatch.setenv("RSCRW_SYNTH_SCALE", "8")
    args = ["--model", "0", "--dataset", "3", "--patch_size", "16", "16", "--overlap", "0",
            "0", "--seq_length", "6", "-c", "6", "-r", "8", "-t", "0.05", "-k", "5",
            "--model_path", checkpoint]
    out = run_both(capsys, "test", args, tmp_path)
    (want, jtxt), (got, ptxt) = out["jax"], out["port"]
    assert lines(ptxt, "Correcting at") == lines(jtxt, "Correcting at")
    assert "Test done." in ptxt
    assert_maps(got, want, margin=False)
    for f in ("_reco.png", "_corr.png"):
        assert (tmp_path / "port" / f).exists(), f


# -- heatmap, show_grid -------------------------------------------------------------


def test_heatmap_matches_jax(capsys, monkeypatch, tmp_path, checkpoint):
    monkeypatch.setenv("RSCRW_DATA_ROOT", "/nonexistent-rscrw-root")
    monkeypatch.setenv("RSCRW_SYNTH_SCALE", "8")
    args = ["--model", "0", "--dataset", "3", "--patch_size", "16", "16", "--overlap", "8", "0",
            "--model_path", checkpoint, "--input_folder", str(tmp_path / "in")]
    out = run_both(capsys, "heatmap", args, tmp_path)
    ptxt, jtxt = out["port"][1], out["jax"][1]
    assert lines(ptxt, "PELT breakpoints") == lines(jtxt, "PELT breakpoints")
    assert "Heatmap done." in ptxt
    for f in ("_heatmap.png", "_heatmap.pdf"):
        assert (tmp_path / "port" / f).exists(), f


def test_show_grid_matches_jax(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("RSCRW_DATA_ROOT", FIXTURE_ROOT)
    outs = {}
    for side, mod, extra in (("jax", None, []), ("port", port_cli("show_grid"),
                                                 ["--device", "cpu"])):
        png = str(tmp_path / f"{side}.png")
        argv = ["--dataset", "0", "--seq_length", "3", "--patch_size", "16", "16",
                "--output", png, *extra]
        if mod is None:  # the JAX script parses its flags under __main__
            monkeypatch.setattr(sys, "argv", ["show_grid.py", *argv])
            if SCRIPTS not in sys.path:
                sys.path.insert(0, SCRIPTS)
            capsys.readouterr()
            runpy.run_path(os.path.join(SCRIPTS, "show_grid.py"), run_name="__main__")
        else:
            capsys.readouterr()
            mod.main(mod.get_args_parser().parse_args(argv))
        outs[side] = capsys.readouterr().out.replace(png, "<png>")
        assert os.path.exists(png)
    assert lines(outs["port"], "Saved patch grid") == lines(outs["jax"], "Saved patch grid")


# -- entry-point behaviour ----------------------------------------------------------


@pytest.mark.parametrize("name", CLIS)
def test_every_cli_defaults_to_cuda_and_refuses_without_it(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = port_cli(name)
    args = mod.get_args_parser().parse_args(["--allow_untrained"] if name != "show_grid" else [])
    assert args.device == "cuda"
    if hasattr(args, "kernel"):
        assert args.kernel == "auto"
    with contextlib.redirect_stdout(open(os.devnull, "w")), \
            pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)


def test_load_encoder(tmp_path, checkpoint, capsys):
    with pytest.raises(FileNotFoundError, match="--allow_untrained"):
        _common.load_encoder(0, False, str(tmp_path / "none.pt"), device="cpu")
    a = _common.load_encoder(1, False, None, allow_untrained=True, device="cpu")
    b = _common.load_encoder(1, False, str(tmp_path / "none.pt"), allow_untrained=True,
                             device="cpu")
    assert "[warn] model weights not found" in capsys.readouterr().out
    for k, v in a.state_dict().items():  # the fresh init is seed 11's, run after run
        assert torch.equal(b.state_dict()[k], v), k
    c = _common.load_encoder(0, False, checkpoint, device="cpu")
    assert "Loaded encoder weights" in capsys.readouterr().out and not c.training
    assert _common.normalize_pair([16]) == (16, 16) and _common.normalize_pair((8, 0)) == (8, 0)


def test_test_all_as_a_module(tmp_path, checkpoint):
    """`python -m radar_sounder_crw_tpu_torch.cli.test_all` on the fixture:
    exit 0 with --device cpu, a refusal without a GPU otherwise."""
    env = dict(os.environ, RSCRW_DATA_ROOT=FIXTURE_ROOT, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "radar_sounder_crw_tpu_torch.cli.test_all", "--model", "0",
           "--dataset", "0", "--patch_size", "16", "16", "--overlap", "8", "0",
           "--seq_length", "6", *GENERIC, "--no_plots", "--model_path", checkpoint,
           "--output_folder", str(tmp_path / "out")]
    proc = subprocess.run([*cmd, "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mIoU:" in proc.stdout and "using synthetic" not in proc.stdout
    assert (tmp_path / "out" / "predicted_map.pt").exists()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
