"""Driver: annotators seeding a new window, as the annotation server's
`seed` command does: `PropagationPipeline.__call__(window, first-frame
ground truth, detect_change=True)` on a host window, its class map, xent
map and change point fetched to the host. Closed loop, one annotator, no
think time; request i takes window i mod `windows`, the windows laid
without overlap over `radargrams` radargrams made from the seed.

Mix keys: radargrams, windows, trace_seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import arith, synth
from portbench.entries import common
from portbench.reference import propagate as ref
from portbench.trace import span


def setup(ctx):
    from radar_sounder_crw_tpu_torch.data.radargram import RGWindows

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    T, N, h, w, oh, ow = common.geometry(cfg)
    seeds = common.child_seeds(ctx.seed, 1 + mix["radargrams"])
    per_rg = -(-mix["windows"] // mix["radargrams"])
    rgs, wins = [], []
    for k in range(mix["radargrams"]):
        rg, seg = synth.radargram(cfg["rows"], cfg["width"], cfg["nclasses"], seeds[1 + k], dev)
        rg_host, seg_host = rg.cpu().numpy(), seg.to(torch.int32).cpu().numpy()
        rgs.append((rg_host, seg_host))
        if k == 0:
            sd = common.make_weights(cfg, seeds[0], dev, rg)
        ds = RGWindows(rg_host, length=T, dim=(h, w), overlap=(oh, ow))
        for j in range(per_rg):
            if len(wins) == mix["windows"]:
                break
            idx = j * T
            x0 = idx * (w - ow)
            wins.append({"rg": k, "x0": x0, "seq": ds[idx],
                         "seg_ref": seg_host[:N * (h - oh) + oh, x0:x0 + w]})
    model = common.program_encoder(cfg, sd, dev)
    pipe = common.pipeline(cfg, model, dev, cache_embeddings=True)
    state = common.State(config=cfg, mix=mix, device=dev, seed=ctx.seed, sd=sd, model=model,
                         pipe=pipe, rgs=rgs, wins=wins, outputs=[], geo=(T, N, h, w, oh, ow))
    p = cfg["propagation"]
    ops = 0
    state.prop_bound_s = 0.0
    for t in range(1, T):
        o, b = arith.step_flops_bytes(1 + p["cxt_size"], N, cfg["embed_dim"], cfg["nclasses"],
                                      p["knn"], 1 + min(t, p["cxt_size"]))
        ops += o
        state.prop_bound_s += arith.bound_seconds(o, b)
    state.flops = (T * N * arith.encoder_flops(h, w) + arith.xent_flops(1, T, N, cfg["embed_dim"])
                   + ops)
    for i in range(len(wins)):  # each window once
        request(state, i)
    state.log.clear()
    state.outputs.clear()
    return state


def request(state, i):
    win = state.wins[i % len(state.wins)]
    with span("seed.call"):
        res = state.pipe(win["seq"], win["seg_ref"], detect_change=True)
    state.outputs.append((i % len(state.wins), res.prediction.astype(np.int8), res.xent,
                          res.change_idx))
    state.log.append({"flops": state.flops, "prop_bound_s": state.prop_bound_s})
    return 1


def finish(state):
    common.synchronize(state.device)


def counters(state):
    return {"prop_launches": common.launches()}


def _reference(state, precise=True):
    """Per window: (soft (T, N, M), xent (N, T-1), change point)."""
    from portbench.reference import pelt

    cfg = state.config
    T, N, h, w, oh, ow = state.geo
    out = []
    for k, (rg_host, seg) in enumerate(state.rgs):
        ws = [win for win in state.wins if win["rg"] == k]
        if not ws:
            continue
        rg = torch.as_tensor(rg_host, device=state.device)
        patches = ref.windows(rg, [win["x0"] for win in ws], T, N, (h, w), (oh, ow))
        emb = common.reference_embed(state.sd, patches, precise)
        seeds = torch.as_tensor(np.stack([ref.seed_labels(win["seg_ref"], N) for win in ws]),
                                device=state.device)
        with common.tf32(not precise):
            soft = ref.propagate(emb, seeds, **common.prop_args(cfg))
            xent = ref.xent_map(emb, cfg["xent_tau"])
        sig = ref.change_signal(xent).cpu().numpy()
        for b in range(len(ws)):
            out.append((soft[b], xent[b], pelt.detect_change_point(sig[b], pen=cfg["pelt_pen"])
                        if T >= 4 else None))
    return out


def _numbers(state, outputs, refs, limits):
    xent_gap, mism, tot = 0.0, 0, [0, 0]
    for j, pred, xent, change in outputs:
        soft, xr, cr = refs[j]
        d = ref.disagreements(soft, torch.as_tensor(pred, device=soft.device).T)
        tot = [a + b for a, b in zip(tot, d)]
        x = torch.as_tensor(xent, device=xr.device)
        xent_gap = max(xent_gap, float((x - xr).abs().max() / xr.abs().max()))
        mism += int(change != cr)
    if not outputs:
        xent_gap = mism = float("inf")
        tot = [float("inf"), 1]
    return [("xent_rel_gap", float(xent_gap), limits.get("xent_rel_gap")),
            ("class_disagree", float(tot[0] / tot[1]), limits.get("class_disagree")),
            ("change_mismatches", float(mism), limits.get("change_mismatches"))]


def check(state, limits):
    outputs = list(state.outputs)
    common.release(state, "pipe", "model")
    return _numbers(state, outputs, _reference(state), limits)


def control(state, limits, n: int):
    """The reference in TF32 in the program's place for requests 0..n-1."""
    common.release(state, "pipe", "model")
    lo = _reference(state, precise=False)
    outputs = []
    for i in range(n):
        j = i % len(state.wins)
        soft, xent, change = lo[j]
        outputs.append((j, soft.argmax(-1).T.to(torch.int8).cpu().numpy(),
                        xent.cpu().numpy(), change))
    return _numbers(state, outputs, _reference(state), limits)
