"""The port's qualitative entry points (cli.test_mc1, cli.test_mc3,
cli.test_sharad and their shared cli._qualitative) vs the JAX package's
scripts (CPU), in-process, on the scripts' synthetic stand-ins with one
shared ResNet-10 checkpoint (tests/test_torch_cli.py). The saved maps follow
the map rule of ROADMAP.md (>= 99.5 % equal; equal where a run's maps are
equal, the xent maps then to atol 1e-4), the port's one form (a survey
call a pass) against each of the JAX script's two, its per-radargram loop
and --batched; the fixed change points, the merges and the flip of the
first SHARAD radargram are the scripts' own.
"""

import numpy as np
import pytest

from radar_sounder_crw_tpu_torch.cli import _qualitative
from test_torch_cli import AGREEMENT, jax_script, lines, resnet_checkpoint, run_both  # noqa: F401

XENT_ATOL = 1e-4


def _compare(tmp_path, products, xents=()):
    for f in products:
        got, want = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert got.shape == want.shape and got.dtype == want.dtype, f
        assert (got == want).mean() >= AGREEMENT, f
    for f in xents:
        np.testing.assert_allclose(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f),
                                   atol=XENT_ATOL, rtol=0, err_msg=f)


def _compare_lines(ptxt, jtxt, change, batched):
    """The change points and the correction step equal; the buckets' lines
    only where the JAX script printed them (--batched)."""
    prefixes = (change, "Correction step", *(["Correction batch"] if batched else []))
    assert lines(ptxt, *prefixes) == lines(jtxt, *prefixes)


@pytest.mark.parametrize("batched", [False, True])
def test_mc1_matches_jax(capsys, tmp_path, resnet_checkpoint, batched):
    args = ["--patch_size", "32", "32", "--overlap", "0", "0", "--seq_length", "4", "-c", "4",
            "-r", "10", "-t", "0.1", "-k", "5", "--model_path", resnet_checkpoint,
            "--input_folder", str(tmp_path / "in")]
    out = run_both(capsys, "test_mc1", args, tmp_path, ["--batched"] if batched else [])
    assert "MC1 test done." in out["port"][1]
    assert lines(out["port"][1], "Num of") == lines(out["jax"][1], "Num of")
    _compare(tmp_path, ["mc1_res.npy"])
    for f in ("im0.png", "im0xent.png", "im2r.png", "im2f.png"):
        assert (tmp_path / "port" / f).exists(), f


@pytest.mark.parametrize("batched", [False, True])
def test_mc3_matches_jax(capsys, tmp_path, resnet_checkpoint, batched):
    args = ["--patch_size", "32", "32", "--overlap", "0", "0", "--seq_length", "6", "-c", "6",
            "-r", "10", "-t", "0.01", "-k", "5", "--change_points", "2", "3", "2",
            "--model_path", resnet_checkpoint, "--input_folder", str(tmp_path / "in")]
    out = run_both(capsys, "test_mc3", args, tmp_path, ["--batched"] if batched else [])
    ptxt, jtxt = out["port"][1], out["jax"][1]
    assert "MC3 test done." in ptxt
    _compare_lines(ptxt, jtxt, "Detected change", batched)
    _compare(tmp_path, ["mc3_res.npy", "mc3_resy.npy"], ["mc3_xenty.npy"])
    for f in ("jim0.png", "jim0c.png", "jim2x.png"):
        assert (tmp_path / "port" / f).exists(), f


@pytest.mark.parametrize("batched", [False, True])
def test_sharad_matches_jax(capsys, tmp_path, resnet_checkpoint, batched):
    args = ["--patch_size", "16", "16", "--overlap", "0", "0", "--seq_length", "6", "-c", "6",
            "-r", "8", "-t", "0.1", "-k", "5", "--change_points", "3", "3", "3",
            "--model_path", resnet_checkpoint, "--input_folder", str(tmp_path / "in")]
    out = run_both(capsys, "test_sharad", args, tmp_path, ["--batched"] if batched else [])
    ptxt, jtxt = out["port"][1], out["jax"][1]
    assert "SHARAD test done." in ptxt
    _compare_lines(ptxt, jtxt, "Predicted change", batched)
    _compare(tmp_path, ["s_res.npy"], ["s_xent.npy"])
    assert (tmp_path / "port" / "sharad_xent0.png").exists()


def test_qualitative_helpers_match_jax(tmp_path, capsys):
    """The shared helpers: the manual unfold, the survey's window ids and
    resident windows, file loading with stand-ins (the first radargram
    flipped on request) and the reverse references' fallback."""
    jq = jax_script("_qualitative")
    rgs, sgs = _qualitative.load_files_or_synth(str(tmp_path), ["a.pt", "b.pt"],
                                                ["a_ref.pt", "b_ref.pt"], 4, (64, 96),
                                                seed0=5, flip_first=True)
    jrgs, jsgs = jq.load_files_or_synth(str(tmp_path), ["a.pt", "b.pt"],
                                        ["a_ref.pt", "b_ref.pt"], 4, (64, 96), seed0=5,
                                        flip_first=True)
    for a, b in zip(rgs + sgs, jrgs + jsgs, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    survey = _qualitative.QualitativeSurvey(rgs, (16, 16), (8, 0))
    jsurvey = jq.QualitativeSurvey(jrgs, (16, 16), (8, 0))
    assert survey.ids == jsurvey.ids
    for a, b in zip(survey.seqs, jsurvey.seqs, strict=True):
        assert a.tobytes() == b.tobytes()
    window = _qualitative.window_radargram(rgs[0], (16, 16), (8, 0))
    assert window.tobytes() == jq.window_radargram(rgs[0], (16, 16), (8, 0)).tobytes()
    for i in survey.ids:
        assert survey.source[i].tobytes() == jsurvey.source[i].tobytes()
    with pytest.raises(ValueError, match="cannot be batched"):
        _qualitative.QualitativeSurvey([rgs[0], rgs[1][:, :48]], (16, 16), (8, 0))
    refs = _qualitative.load_refs_or_fallback(str(tmp_path), ["a_r.pt", "b_r.pt"], sgs)
    assert all(np.array_equal(r, s) for r, s in zip(refs, sgs, strict=True))
    assert "seeding from the forward reference" in capsys.readouterr().out
