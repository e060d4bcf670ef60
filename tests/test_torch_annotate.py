"""The port's annotation server (cli.annotate) vs scripts/annotate.py (CPU):
the JSON-lines protocol over pipes, the session in-process against the JAX
session with one shared checkpoint (replies equal but for their wall `ms`,
maps >= 99.5 % equal, equal where the replies' counts are compared), error
replies that leave the session usable, and reseed(0) equal to a fresh seed.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from radar_sounder_crw_tpu_torch.cli import annotate
from radar_sounder_crw_tpu_torch.infer.propagate import seed_onehot_from_segmentation
from test_torch_cli import AGREEMENT, REPO, checkpoint, jax_script  # noqa: F401

ARGS = ["--model", "0", "--dataset", "3", "--seq_length", "8", "--patch_size", "16", "16",
        "--overlap", "8", "0", "--cxt_size", "8", "--radius", "6", "--temp", "0.1", "--knn", "5"]


@pytest.fixture
def synthetic_sharad(monkeypatch):
    monkeypatch.setenv("RSCRW_DATA_ROOT", "/nonexistent-rscrw-root")
    monkeypatch.setenv("RSCRW_SYNTH_SCALE", "8")


def _session(mod, args, checkpoint, extra=()):
    return mod.AnnotationSession(
        mod.get_args_parser().parse_args([*args, "--model_path", checkpoint, *extra]))


def _ask(session, **cmd):
    return session.handle(json.dumps(cmd))


def test_session_matches_jax(synthetic_sharad, checkpoint):
    port = _session(annotate, ARGS, checkpoint, ["--device", "cpu"])
    jax = _session(jax_script("annotate"), ARGS, checkpoint)
    script = [dict(cmd="info"), dict(cmd="load", window=1), dict(cmd="seed", seg="gt"),
              dict(cmd="reseed", frame=3, seg="gt"), dict(cmd="metrics"), dict(cmd="info"),
              dict(cmd="seed", seg="gt", use_last=True), dict(cmd="reseed", frame=5),
              dict(cmd="metrics")]
    for cmd in script:
        got, want = _ask(port, **cmd), _ask(jax, **cmd)
        assert got["ok"] and want["ok"], (cmd, got, want)
        got.pop("ms", None), want.pop("ms", None)
        agree = float((port.pred == jax.pred).mean()) if port.pred is not None else 1.0
        assert agree >= AGREEMENT, cmd
        if agree == 1.0 or cmd["cmd"] in ("info", "load"):
            assert got == want, cmd


def test_reseed_zero_matches_fresh_seed(synthetic_sharad, checkpoint):
    s = _session(annotate, ARGS, checkpoint, ["--device", "cpu"])
    assert _ask(s, cmd="load", window=0)["ok"]
    assert _ask(s, cmd="seed", seg="gt")["ok"]
    first = s.pred.copy()
    r = _ask(s, cmd="reseed", frame=0, seg="gt")
    assert r["ok"] and r["frame"] == 0
    np.testing.assert_array_equal(s.pred, first)


@pytest.mark.parametrize("use_last", [False, True])
def test_seed_orientation_and_reseed_frame(synthetic_sharad, checkpoint, use_last):
    """use_last seeds the last frame and answers in original frame order;
    a reseed's frame is in original order too and keeps the upstream
    frames' map."""
    s = _session(annotate, ARGS, checkpoint, ["--device", "cpu"])
    assert _ask(s, cmd="load")["ok"]
    assert _ask(s, cmd="seed", seg="gt", use_last=use_last)["ok"]
    T, N = 8, s.pred.shape[0]
    seeded = T - 1 if use_last else 0
    _, want = seed_onehot_from_segmentation(s._gt_patch(seeded), N, s.nclasses)
    np.testing.assert_array_equal(s.pred[:, seeded], want)
    before, f = s.pred.copy(), 5
    seg = np.full((s.geo.rg_h(), 16), 2).tolist()
    assert _ask(s, cmd="reseed", frame=f, seg=seg)["ok"]
    assert (s.pred[:, f] == 2).all()
    kept = slice(f + 1, T) if use_last else slice(0, f)
    np.testing.assert_array_equal(s.pred[:, kept], before[:, kept])


def test_protocol_errors_keep_the_session(synthetic_sharad, checkpoint):
    s = _session(annotate, ARGS, checkpoint, ["--device", "cpu"])
    assert "load" in _ask(s, cmd="seed")["error"]
    assert not _ask(s, cmd="load", window=10**6)["ok"]
    assert _ask(s, cmd="load")["ok"]
    for bad in (dict(cmd="seed", seg=[1, 2, 3]), dict(cmd="seed", seg="nope"),
                dict(cmd="reseed"), dict(cmd="metrics"), dict(cmd="save", path="x.npy"),
                dict(cmd="nope"), dict(cmd=None)):
        r = _ask(s, **bad)
        assert r["ok"] is False and r["error"], bad
    assert s.handle("not json at all")["ok"] is False
    assert _ask(s, cmd="seed", seg="gt")["ok"]
    assert not _ask(s, cmd="save")["ok"]


def test_protocol_over_pipes(tmp_path, checkpoint):
    """`python -m radar_sounder_crw_tpu_torch.cli.annotate --device cpu`:
    one JSON reply a line, errors answered, map and plot saved, quit."""
    npy, png = str(tmp_path / "map.npy"), str(tmp_path / "map.png")
    cmds = [{"cmd": "seed"}, {"cmd": "load", "window": 1}, {"cmd": "seed", "seg": "gt"},
            {"cmd": "reseed", "frame": 3, "seg": "gt"}, {"cmd": "metrics"},
            {"cmd": "save", "path": npy, "plot": png}, {"cmd": "nope"}, {"cmd": "info"},
            {"cmd": "quit"}]
    env = dict(os.environ, RSCRW_DATA_ROOT="/nonexistent-rscrw-root", RSCRW_SYNTH_SCALE="8")
    proc = subprocess.run(
        [sys.executable, "-m", "radar_sounder_crw_tpu_torch.cli.annotate", *ARGS,
         "--model_path", checkpoint, "--device", "cpu"],
        input="\n".join(json.dumps(c) for c in cmds) + "\n", capture_output=True, text=True,
        timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ready, *replies = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    assert ready["ok"] and ready["ready"] and len(replies) == len(cmds)
    ok = [r["ok"] for r in replies]
    assert ok == [False, True, True, True, True, True, False, True, True]
    assert replies[2]["ms"] >= 0 and replies[3]["frame"] == 3
    assert 0.0 <= replies[4]["pixel_accuracy"] <= 1.0 and replies[-1]["bye"]
    assert np.load(npy).shape[1] == 8 and os.path.exists(png)
    assert "Loaded encoder weights" in proc.stderr  # logs stay off the protocol
