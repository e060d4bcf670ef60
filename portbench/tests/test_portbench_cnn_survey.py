"""The CNN survey cell (entries/cnn_survey.py): the manifest resolves it with
its per-layer metrics; at toy size on the CPU the whole harness reaches the
reference, and with a fault planted under the timed path (the program's
pools at stride 2, or its forward maps altered) the check reads `correct`
false. Beside it: the reader of the encoder's time per thousand patches,
which reads None without the program's counter."""

from __future__ import annotations

import argparse
import copy
import json
import time
import types

import numpy as np
import pytest
import torch

from portbench import harness, run

from .conftest import ROOT, TOY_PROP, toy_manifest

SEED = 2 ** 34 + 4321  # more than 32 signed bits hold, as a run's seed may be
CELL = "toy-cnn-miguel.cnn_survey"
LIKE = "cnn-miguel.cnn_survey"
METRICS = ("mfu", "idle_share", "encode_ms", "conv_ms", "cnn_pool_ms", "prop_roofline",
           "pelt_ms", "assemble_ms", "encode_us_per_kpatch")


@pytest.fixture
def cnn_survey_root(toy_root):
    """The toy root with a CNN survey cell: lines of 104 x 480 (N 12, 5
    radargrams of T 6; at N 4 the toy maps barely depend on the
    embeddings), the cell's own mix and limits."""
    cfg = json.loads((harness.HERE / "configs" / "cnn-miguel.json").read_text())
    cfg.update(name="toy-cnn-miguel", rows=104, width=480, trim_splits=None, seq_length=6,
               propagation=TOY_PROP)
    (toy_root / "configs" / "toy-cnn-miguel.json").write_text(json.dumps(cfg))
    mix = json.loads((harness.HERE / "traffic" / "cnn_survey.json").read_text())
    (toy_root / "traffic" / "toy-cnn-survey.json").write_text(
        json.dumps(dict(mix, lines=2, sample=1, trace_seconds=0.5)))
    (toy_root / "limits" / f"{CELL}.json").write_text(
        (harness.HERE / "limits" / f"{LIKE}.json").read_text())
    return toy_root


def _manifest():
    m = copy.deepcopy(toy_manifest())
    m["workloads"].append({"name": CELL, "config": "toy-cnn-miguel",
                           "traffic": "toy-cnn-survey", "chips": 1, "why": "toy"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if LIKE in metric.get("workloads", ()):
            metric["workloads"].append(CELL)
    return m


def _run(root, trace=0):
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.6, trace=trace)
    return run.run(args, manifest=_manifest(), roots=(root, harness.HERE), allow_cpu=True,
                   t_start=time.perf_counter())


def test_manifest_resolves_the_cell_with_its_metrics():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    c = harness.resolve(manifest, LIKE)
    assert c.config["model"] == 0 and c.config["reduced"] == []
    assert c.mix["entry"] == "cnn_survey" and c.mix["reports"] == "survey_rg_per_s"
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "survey_rg_per_s"}
    assert sorted(m["name"] for m in c.per_layer) == sorted(f"{s}.cnn_survey" for s in METRICS)
    for m in c.per_layer:
        assert m["moves"] == "survey_rg_per_s" and m["workloads"] == [LIKE]
        assert callable(harness.reader(m["name"]))
    assert set(c.limits) == {"class_disagree", "change_mismatches", "map_mismatches"}
    assert c.limits["change_mismatches"] == 0 and c.limits["map_mismatches"] == 0


@pytest.mark.parametrize("trace", [0, 1])
def test_toy_cnn_survey_reaches_the_reference(cnn_survey_root, trace):
    r = _run(cnn_survey_root, trace)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["check"]) == {"class_disagree", "change_mismatches", "map_mismatches"}
    if trace:
        assert not r["metrics"], "no device metric is read from a CPU run"
    else:
        assert set(r["metrics"]) == {"setup_s", "survey_rg_per_s"}


def test_counters_count_the_cnn_patches(cnn_survey_root):
    """Each request adds every patch of its passes to `encode_patches`, and
    its operations are survey.py's with the CNN's forward for each patch."""
    from portbench import arith, cnn_arith
    from portbench.entries import cnn_survey
    from portbench.run import Ctx

    cell = harness.resolve(_manifest(), CELL, (cnn_survey_root, harness.HERE))
    state = cnn_survey.setup(Ctx(cell.config, cell.mix, SEED, torch.device("cpu")))
    before = cnn_survey.counters(state)
    R = cnn_survey.request(state, 0)
    after = cnn_survey.counters(state)
    T, N, h, w, _, _ = state.geo
    out = state.outputs[0]
    frames = 2 * R * T + sum(s for s, _ in out["corrected"])
    assert after["encode_patches"] - before["encode_patches"] == frames * N
    cfg, p = state.config, state.config["propagation"]

    def prop(B, L):
        return arith.seq_flops_bytes(B, L, N, cfg["embed_dim"], cfg["nclasses"], p["knn"], 1,
                                     p["cxt_size"])[0]

    groups: dict = {}
    for small, _ in out["corrected"]:
        groups[small] = groups.get(small, 0) + 1
    want = frames * N * cnn_arith.encoder_flops(h, w) + 2 * prop(R, T) \
        + arith.xent_flops(R, T, N, cfg["embed_dim"]) + sum(prop(b, s) for s, b in groups.items())
    assert state.log[-1]["flops"] == want


def test_fault_pools_at_stride_two(cnn_survey_root, monkeypatch):
    """The program's max-pools at stride 2, as the published code's are not."""
    from radar_sounder_crw_tpu_torch.models import encoders

    orig = encoders.CNNEncoder.__init__

    def strided(self, *a, **kw):
        orig(self, *a, **kw)
        self.pool = torch.nn.MaxPool2d(2, stride=2)

    monkeypatch.setattr(encoders.CNNEncoder, "__init__", strided)
    r = _run(cnn_survey_root)
    assert not r["correct"] and r["check"]["class_disagree"]["value"] > 1e-5


def test_fault_forward_map_altered(cnn_survey_root, monkeypatch):
    """Every node of the middle frame of each forward map moved to the next
    class."""
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline

    orig = PropagationPipeline.propagate_survey

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        pred = np.array(out[0] if isinstance(out, tuple) else out, copy=True)
        pred[..., pred.shape[-1] // 2] = (pred[..., pred.shape[-1] // 2] + 1) % self.nclasses
        return (pred, *out[1:]) if isinstance(out, tuple) else pred

    monkeypatch.setattr(PropagationPipeline, "propagate_survey", altered)
    assert not _run(cnn_survey_root)["correct"]


def _trace(counters, encode_s, requests=2):
    return types.SimpleNamespace(counters=counters, requests=requests, encode_s=encode_s)


@pytest.fixture
def read(monkeypatch):
    """The reader with the device seconds of `crw.encode` taken from the
    synthetic trace."""
    from portbench import spans

    monkeypatch.setattr(spans, "device_seconds",
                        lambda trace, name: trace.encode_s if name == "crw.encode" else None)
    return harness.reader("encode_us_per_kpatch.cnn_survey")


def test_encode_per_kpatch_reader(read):
    """1.4 s of encode over 1,000,000 patches: 1,400 us a thousand."""
    t = _trace({"encode_patches": 1_000_000, "prop_launches": 7}, 1.4)
    assert read(t, None) == pytest.approx(1400.0)


def test_encode_per_kpatch_reader_none_without_counter_or_span(read):
    for t in (_trace({"prop_launches": 7}, 1.4), _trace({"encode_patches": 0}, 1.4),
              _trace({"encode_patches": 1000}, None)):
        assert read(t, None) is None
