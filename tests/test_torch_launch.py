"""The port's sweep launchers (radar_sounder_crw_tpu_torch/launch/*.sh) vs the
JAX package's (scripts/launch/*.sh), on the CPU.

Each launcher runs with stub `python` and `python3` commands first on PATH,
which record their name, working directory and argv and exit 0, so no run
starts. The port's calls must equal the JAX side's call for call and in
order, with `python scripts/<name>.py` read as `python3 -m
radar_sounder_crw_tpu_torch.cli.<name>`, each from the repo root with the
launcher's own arguments last; every argv must parse under the port CLI's
parser to the JAX script's values. A stub that fails on the second call
stops both batch launchers there (`set -e`).
"""

import importlib
import os
import shutil
import subprocess

import pytest

from test_torch_cli import REPO, SCRIPTS, jax_script

JAX_LAUNCH = os.path.join(SCRIPTS, "launch")
PORT_LAUNCH = os.path.join(REPO, "radar_sounder_crw_tpu_torch", "launch")
BASH = shutil.which("bash")

# launcher -> (the CLI it runs, its number of runs, arguments passed through)
LAUNCHERS = {
    "launch_test": ("test_all", 1, ["--model", "0", "--allow_untrained", "-c", "8"]),
    "launch_test_batch": ("test_all", 27, ["--model", "0", "--allow_untrained"]),
    "launch_train": ("train", 1, ["--dataset", "0", "--epochs", "1", "--seq_length", "6"]),
    "launch_train_batch": ("train", 81, ["--dataset", "0", "--epochs", "1"]),
}

# Appends one line a call: the command's name, $PWD, then each argument,
# tab-separated; exits 1 from call number $STUB_FAIL_AT on.
STUB = """#!/bin/sh
{ printf '%s' "$(basename "$0")"; printf '\\t%s' "$PWD" "$@"; printf '\\n'; } >> "$STUB_RECORD"
if [ -n "${STUB_FAIL_AT:-}" ] && [ "$(wc -l < "$STUB_RECORD")" -ge "$STUB_FAIL_AT" ]; then
  exit 1
fi
exit 0
"""


def run_launcher(path, args, tmp, fail_at=None):
    """Run `path` with the stubs first on PATH, from a directory that is not
    the repo root: (exit code, [(command, cwd, argv)] a call)."""
    bin_dir = os.path.join(tmp, "bin")
    os.makedirs(bin_dir, exist_ok=True)
    for name in ("python", "python3"):
        stub = os.path.join(bin_dir, name)
        with open(stub, "w") as f:
            f.write(STUB)
        os.chmod(stub, 0o755)
    record = os.path.join(tmp, "calls.tsv")
    env = dict(os.environ, PATH=bin_dir + os.pathsep + os.environ["PATH"], STUB_RECORD=record)
    if fail_at is not None:
        env["STUB_FAIL_AT"] = str(fail_at)
    proc = subprocess.run([BASH, path, *args], cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=60)
    calls = []
    if os.path.exists(record):
        with open(record) as f:
            for line in f.read().splitlines():
                command, cwd, *argv = line.split("\t")
                calls.append((command, cwd, argv))
    return proc.returncode, calls


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """{launcher: (JAX calls, port calls)}, each launcher run once."""
    out = {}
    for name, (_, _, extra) in LAUNCHERS.items():
        sides = []
        for side, folder in (("jax", JAX_LAUNCH), ("port", PORT_LAUNCH)):
            rc, calls = run_launcher(os.path.join(folder, f"{name}.sh"), extra,
                                     str(tmp_path_factory.mktemp(f"{side}_{name}")))
            assert rc == 0, (side, name, rc)
            sides.append(calls)
        out[name] = tuple(sides)
    return out


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_is_executable_bash(name):
    path = os.path.join(PORT_LAUNCH, f"{name}.sh")
    assert os.access(path, os.X_OK), path
    proc = subprocess.run([BASH, "-n", path], capture_output=True, text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr
    with open(path) as f:
        head = f.read().splitlines()[:8]
    assert head[0] == "#!/usr/bin/env bash"
    assert "set -euo pipefail" in head


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_calls_match_jax(recorded, name):
    cli, runs, extra = LAUNCHERS[name]
    jax_calls, port_calls = recorded[name]
    assert len(jax_calls) == len(port_calls) == runs
    for (jax_cmd, jax_cwd, jax_argv), (port_cmd, port_cwd, port_argv) in zip(
            jax_calls, port_calls):
        assert jax_cmd == "python" and port_cmd == "python3"
        assert jax_argv[0] == f"scripts/{cli}.py"
        assert port_argv[:2] == ["-m", f"radar_sounder_crw_tpu_torch.cli.{cli}"]
        assert port_argv[2:] == jax_argv[1:]
        assert port_argv[-len(extra):] == extra
        for cwd in (jax_cwd, port_cwd):
            assert os.path.realpath(cwd) == os.path.realpath(REPO)


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_argv_parses_as_jax(recorded, name):
    cli, _, _ = LAUNCHERS[name]
    jax_parser = jax_script(cli).get_args_parser()
    port_parser = importlib.import_module(
        f"radar_sounder_crw_tpu_torch.cli.{cli}").get_args_parser()
    jax_calls, port_calls = recorded[name]
    seen = set()
    for (_, _, jax_argv), (_, _, port_argv) in zip(jax_calls, port_calls):
        want = vars(jax_parser.parse_args(jax_argv[1:]))
        got = vars(port_parser.parse_args(port_argv[2:]))
        shared = sorted(set(want) & set(got))
        assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
        seen.add(tuple(str(want[k]) for k in ("seq_length", "lr", "tau", "overlap", "radius",
                                              "temp", "knn") if k in want))
    assert len(seen) == len(jax_calls)  # every grid point once


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("name", ["launch_test_batch", "launch_train_batch"])
def test_batch_launcher_stops_on_failure(tmp_path, side, name):
    folder = JAX_LAUNCH if side == "jax" else PORT_LAUNCH
    rc, calls = run_launcher(os.path.join(folder, f"{name}.sh"), [], str(tmp_path),
                             fail_at=2)
    assert rc != 0
    assert len(calls) == 2
