"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and a
CUDA default that refuses to run elsewhere unless the caller says so."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
from radar_sounder_crw_tpu_torch.models import create_model
from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig, propagate_labels
from radar_sounder_crw_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "radar_sounder_crw_tpu_torch")
FORBIDDEN = re.compile(
    r"^\s*(from|import)\s+(jax|flax|optax|radar_sounder_crw_tpu)(\.|\s|$)", re.M
)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="radar_sounder_crw_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    """Every module, the entry points under cli/ included, imports with JAX,
    the JAX package and matplotlib (absent on the card's machine; the plots
    import it when they draw) all unimportable."""
    mods = ["radar_sounder_crw_tpu_torch", *_port_modules(), "chip_smoke"]
    assert len(mods) >= 15
    port = "radar_sounder_crw_tpu_torch."
    for name in ("ops.metrics", "utils.ndiag", "utils.plotting", "data.torch_pt",
                 "models.checkpoint", "cli._common", "cli._qualitative", "cli.test_all",
                 "cli.test", "cli.test_mc1", "cli.test_mc3", "cli.test_sharad", "cli.annotate",
                 "cli.heatmap", "cli.show_grid"):
        assert port + name in mods, name
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'radar_sounder_crw_tpu',"
        " 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_import_nothing_of_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 15
    offenders = [f for f in files if FORBIDDEN.search(open(f).read())]
    assert offenders == []
    # the scan itself catches what it is meant to
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from radar_sounder_crw_tpu.ops import pelt")
    assert not FORBIDDEN.search("from radar_sounder_crw_tpu_torch.ops import pelt")


def test_entry_points_default_to_cuda_and_refuse_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = np.zeros((2, 3, 4), np.float32)
    seed = np.eye(2, dtype=np.float32)[[0, 1, 0]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(0, False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        propagate_labels(emb, seed, LabelPropConfig())
    model = create_model(0, False, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PropagationPipeline(model, LabelPropConfig(), 2)
    with pytest.raises(ValueError, match="CUDA device"):
        PropagationPipeline(model, LabelPropConfig(), 2, kernel="cuda", device="cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no result,
    and so it does alone in a directory without the package."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:
            (tmp_path / script).write_text(open(os.path.join(REPO, script)).read())
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=120,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
