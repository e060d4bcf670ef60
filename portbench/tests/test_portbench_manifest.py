"""BENCHMARK.json against the harness: every cell resolves by name to its
configuration, mix, limits, driver and per-layer readers, and the manifest
keeps the shape the benchmark's contract fixes."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness

from .conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.resolve(MANIFEST, cell)
    assert harness.entry_module(c.mix["entry"]).request
    assert c.mix["statistic"] in harness.ENTRY_METRIC_STATISTICS
    reported = {m["name"] for m in c.end_to_end}
    assert {"setup_s", c.mix["reports"]} <= reported
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(harness.reader(m["name"]))
    for name, limit in c.limits.items():
        assert isinstance(limit, (int, float)) and limit >= 0, name


def test_names_units_and_sources():
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_are_used_and_files_exist():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["embed_dim"] == 128 and cfg["patch"] == [16, 16]


def test_a_toy_cell_needs_only_new_files(toy_root):
    """A later cell is files and manifest entries: a mix, a configuration,
    limits and a per-layer reader that exist only in this fixture resolve
    through the unchanged harness."""
    (toy_root / "metrics" / "toy_count.py").write_text(
        "def read(trace, cell):\n    return float(trace.requests)\n")
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": "toy-sharad.seed", "config": "toy-sharad",
                           "traffic": "toy-seed", "chips": 1, "why": "toy"})
    m["per_layer"].append({"name": "toy_count.seed", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "test",
                           "moves": "seed_p95_ms", "workloads": ["toy-sharad.seed"]})
    c = harness.resolve(m, "toy-sharad.seed", roots=(toy_root, harness.HERE))
    assert c.config["name"] == "toy-sharad" and c.mix["entry"] == "seed"
    assert [x["name"] for x in c.per_layer] == ["toy_count.seed"]
    assert harness.reader("toy_count.seed", roots=(toy_root, harness.HERE))(
        type("T", (), {"requests": 3})(), c) == 3.0
