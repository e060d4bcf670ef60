"""The control of each cell's check, on the card at the cell's own size: the
plain reference in TF32, one precision below the configurations' float32
with TF32 off, put in the program's place, has to come out not correct; in
the training cell so has the reference on half of each batch.

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_control.py
"""

from __future__ import annotations

import json

import pytest
import torch

from portbench import harness
from portbench.run import ROOT, Ctx

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CASES = [(w["name"], "tf32") for w in MANIFEST["workloads"]] + [
    (w["name"], "half_batch") for w in MANIFEST["workloads"]
    if json.loads((harness.HERE / "traffic" / f"{w['traffic']}.json").read_text())["entry"]
    == "train"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", CASES)
def test_control_is_not_correct(cell, fault):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card: TF32 exists only there")
    c = harness.resolve(MANIFEST, cell)
    entry = harness.entry_module(c.mix["entry"])
    state = entry.setup(Ctx(c.config, c.mix, 2 ** 31 + 77, torch.device("cuda")))
    kw = {} if fault == "tf32" else {"fault": fault}
    numbers = entry.control(state, c.limits, 1 if c.mix["entry"] == "survey" else 20, **kw)
    assert not harness.judge(numbers), numbers
