"""Toy cells for the harness's CPU tests: the benchmark's own mixes and
limits on configurations cut to a few patches, plus a toy cell that exists
only here (its configuration, mix, limits and a per-layer reader are files
of this fixture), run through the same harness on the CPU."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.HERE.parent

TOY_PROP = {"cxt_size": 3, "radius": 2, "temperature": 0.1, "knn": 3}


def toy_configs() -> dict:
    base = {k: v for k, v in json.loads((harness.HERE / "configs" / "resnet10-miguel.json")
                                        .read_text()).items()}
    miguel = dict(base, name="toy-miguel", rows=40, width=480, trim_splits=None,
                  seq_length=6, propagation=TOY_PROP)
    sharad = json.loads((harness.HERE / "configs" / "resnet10-sharad.json").read_text())
    sharad = dict(sharad, name="toy-sharad", rows=40, width=400, seq_length=6,
                  propagation=TOY_PROP,
                  train=dict(sharad["train"], batch_size=2, seq_length=4))
    return {"toy-miguel": miguel, "toy-sharad": sharad}


TOY_MIXES = {
    "toy-survey": {"entry": "survey", "reports": "survey_rg_per_s", "statistic": "rate",
                   "lines": 2, "correction": True, "use_last": True, "sample": 1,
                   "trace_seconds": 0.5},
    "toy-seed": {"entry": "seed", "reports": "seed_p95_ms", "statistic": "p95_ms",
                 "radargrams": 2, "windows": 5, "trace_seconds": 0.5},
    "toy-reseed": {"entry": "reseed", "reports": "reseed_p95_ms", "statistic": "p95_ms",
                   "sessions": 3, "frame_low": 1, "frame_high": 4, "bucket": 4,
                   "trace_seconds": 0.5},
    "toy-train": {"entry": "train", "reports": "train_steps_per_s", "statistic": "rate",
                  "radargrams": 1, "checked_steps": 3, "trace_seconds": 0.5},
}

# a cell of each benchmark kind on the toy configurations, with the
# benchmark's own limits
TOY_CELLS = {
    "toy-miguel.survey": ("toy-miguel", "toy-survey", "resnet10-miguel.survey"),
    "toy-sharad.seed": ("toy-sharad", "toy-seed", "resnet10-sharad.seed"),
    "toy-miguel.reseed": ("toy-miguel", "toy-reseed", "resnet10-miguel.reseed"),
    "toy-sharad.train": ("toy-sharad", "toy-train", "resnet10-sharad.train"),
}


def toy_manifest() -> dict:
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = copy.deepcopy(real)
    for name, (config, mix, like) in TOY_CELLS.items():
        m["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                               "why": "toy"})
        for metric in m["end_to_end"] + m["per_layer"]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(name)
    return m


@pytest.fixture
def toy_root(tmp_path: Path) -> Path:
    for sub in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / sub).mkdir()
    for name, cfg in toy_configs().items():
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, mix in TOY_MIXES.items():
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (_, _, like) in TOY_CELLS.items():
        (tmp_path / "limits" / f"{name}.json").write_text(
            (harness.HERE / "limits" / f"{like}.json").read_text())
    return tmp_path
