"""The port's UNet entry point (radar_sounder_crw_tpu_torch/cli/test_unet.py)
vs the JAX package's script (scripts/test_unet.py), in-process on the CPU at
tests/test_script_smokes.py's flags, on synthetic SHARAD shrunk 8x
(RSCRW_SYNTH_SCALE=8: 16 strips of 912 x 64, 14 to train at batch 8, 2 held
out); the port runs with --device cpu. The two sides start from their own
random inits, so the checks are the entry point's contract: one epoch line,
the classification report and `mIoU:`, over the same held-out pixels.
Values are held to the JAX package by tests/test_torch_unet.py.
"""

from radar_sounder_crw_tpu_torch.cli import test_unet as port_test_unet
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from test_torch_train_cli import jax_script, run

UNET_FLAGS = ["--patch_size", "912", "64", "--batch_size", "8", "--epochs", "1", "--lr", "1e-3"]


def test_test_unet_matches_the_script(monkeypatch):
    monkeypatch.setenv("RSCRW_SYNTH_SCALE", "8")
    monkeypatch.delenv("RSCRW_DATA_ROOT", raising=False)
    reports = {}
    for side, module, extra in (("jax", jax_script("test_unet"), []),
                                ("port", port_test_unet, ["--device", "cpu"])):
        text, _ = run(module, [*UNET_FLAGS, *extra])
        assert "mIoU:" in text and "accuracy" in text, text
        assert any(ln.startswith("Epoch: 1 Loss: ") for ln in text.splitlines()), text
        reports[side] = text
    # the same held-out strips: the report's support column (pixels per class)
    support = {side: [ln.split()[-1] for ln in t.splitlines() if ln.strip()[:1].isdigit()]
               for side, t in reports.items()}
    assert support["port"] == support["jax"] and support["port"]
