"""The harness core: finds a cell's configuration, traffic mix, limits and
per-layer readers by name, runs set-up, the measured window and the check,
and assembles the result line.

Everything that belongs to one configuration, mix, cell or per-layer metric
is a file of its own, found by the name in BENCHMARK.json:
  configs/<config>.json     sizes, dtype, source, what was cut
  traffic/<mix>.json        parameters for the general driver named by its
                            "entry" key (entries/<entry>.py), the end-to-end
                            metric it reports and the statistic taken
  limits/<workload>.json    the limit of each number the check compares
  metrics/<metric>.py       a reader of one per-layer metric (or of every
                            metric <stem>.*, as metrics/<stem>.py), called
                            with the traced window; it returns None where it
                            finds nothing to read
A later cell, mix, configuration or metric is a set of new files and
BENCHMARK.json entries; no file here needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "radar_sounder_crw_tpu")
ENTRY_METRIC_STATISTICS = ("rate", "p95_ms")


class Refused(RuntimeError):
    """A run that must exit without a result."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # manifest entries this cell reports with --trace 0
    per_layer: list  # manifest entries this cell reports with --trace 1


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(roots, sub: str, name: str, suffix: str) -> Path:
    """The first roots[i]/sub/name+suffix that exists."""
    for root in roots:
        p = Path(root) / sub / f"{name}{suffix}"
        if p.exists():
            return p
    raise FileNotFoundError(f"no {sub}/{name}{suffix} under {[str(r) for r in roots]}")


def resolve(manifest: dict, workload: str, roots=(HERE,)) -> Cell:
    """The cell `workload` of `manifest` with its files read."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r} (have {sorted(cells)})")
    w = cells[workload]
    config = _load_json(find(roots, "configs", w["config"], ".json"))
    mix = _load_json(find(roots, "traffic", w["traffic"], ".json"))
    limits = _load_json(find(roots, "limits", workload, ".json"))
    reported = mix["reports"]
    e2e = [m for m in manifest["end_to_end"]
           if m["name"] == "setup_s" or m["name"] == reported
           or workload in m.get("workloads", ())]
    per_layer = [m for m in manifest["per_layer"]
                 if workload in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] == reported)]
    return Cell(workload, config, mix, limits, e2e, per_layer)


def reader(name: str, roots=(HERE,)):
    """The `read` function of metric `name`: metrics/<name>.py, else
    metrics/<stem>.py for the part of the name before its first dot."""
    for cand in (name, name.split(".")[0]):
        try:
            path = find(roots, "metrics", cand, ".py")
        except FileNotFoundError:
            continue
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{cand}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r}")


def entry_module(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def statistic(kind: str, latencies: list, units: float, window_s: float) -> float:
    if kind == "rate":
        return units / window_s
    if kind == "p95_ms":
        return float(np.percentile(np.asarray(latencies), 95)) * 1e3
    raise ValueError(f"unknown statistic {kind!r} (have {ENTRY_METRIC_STATISTICS})")


@dataclasses.dataclass
class Window:
    """What the measured window did: one record per request."""

    t0: float = 0.0
    t1: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    units: float = 0.0
    requests: int = 0
    failed: int = 0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def drive(entry, state, seconds: float, start_index: int = 0) -> Window:
    """Closed loop, one caller: request i + 1 goes out when request i has
    returned. The window closes when the request in flight at `seconds`
    has completed, so its time and its work both count."""
    win = Window()
    i = start_index
    win.t0 = time.perf_counter()
    deadline = win.t0 + seconds
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        try:
            win.units += entry.request(state, i)
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
            win.failed += 1
            print(f"[portbench] request {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
        win.latencies.append(time.perf_counter() - t)
        win.requests += 1
        i += 1
    entry.finish(state)
    win.t1 = time.perf_counter()
    return win


def judge(numbers: list) -> bool:
    """[(name, value, limit)]: correct when every value is a number no
    larger than its limit."""
    return all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in numbers)


def numbers_text(numbers: list) -> str:
    return "\n".join(f"{n} {v!r} limit {lim!r}" for n, v, lim in numbers)
