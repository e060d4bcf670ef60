"""Driver: annotators correcting a frame, as the annotation server's `reseed`
command does: `PropagationPipeline.reseed(ground truth at frame f, f)` on a
session whose window was encoded and seeded at set-up. The encoder is
bypassed; the request is the frame loop of propagation over frames f..T-1
(padded to the pipeline's bucket) and the splice into the session's map.
Closed loop, one annotator, no think time: request i takes session
i mod `sessions` and a frame f drawn uniformly from [frame_low, frame_high]
by the seed. The sessions are radargram windows of one line made from the
seed, each with a pipeline of its own.

Mix keys: sessions, frame_low, frame_high, bucket, trace_seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import arith, synth
from portbench.entries import common
from portbench.reference import propagate as ref
from portbench.reference import survey as ref_survey
from portbench.trace import span


def setup(ctx):
    from radar_sounder_crw_tpu_torch.data.radargram import RGWindows

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    T, N, h, w, oh, ow = common.geometry(cfg)
    seeds = common.child_seeds(ctx.seed, 3)
    rg, seg = synth.radargram(cfg["rows"], cfg["width"], cfg["nclasses"], seeds[1], dev)
    sd = common.make_weights(cfg, seeds[0], dev, rg)
    model = common.program_encoder(cfg, sd, dev)
    rg_host, seg_host = rg.cpu().numpy(), seg.to(torch.int32).cpu().numpy()
    del rg, seg
    if cfg.get("trim_splits"):
        seg_host = ref_survey.trim(seg_host, cfg["trim_splits"], T, w)
    ds = RGWindows(rg_host, length=T, dim=(h, w), overlap=(oh, ow),
                   trim_miguel_splits=bool(cfg.get("trim_splits")))
    rng = np.random.default_rng(seeds[2])
    n_rg = len(ds) // T + (1 if len(ds) % T else 0)
    picks = rng.choice(n_rg, size=mix["sessions"], replace=False)
    sessions = []
    for r in picks:
        idx = int(r) * T
        x0 = idx * (w - ow)
        pipe = common.pipeline(cfg, model, dev, cache_embeddings=True)
        sessions.append({"x0": x0, "seq": ds[idx], "pipe": pipe})
    state = common.State(config=cfg, mix=mix, device=dev, seed=ctx.seed, sd=sd, model=model,
                         sessions=sessions, seg=seg_host, rg=rg_host, outputs=[],
                         geo=(T, N, h, w, oh, ow), frames=np.random.default_rng([ctx.seed, 7]))
    state.schedule = []
    for s in sessions:  # the annotator's first seed: encode, xent, PELT, propagate
        s["map"] = s["pipe"](s["seq"], _gt(state, s, 0), detect_change=True).prediction
    # warm-up: every padded tail length once
    bucket = mix["bucket"]
    for f in sorted({T - b for b in range(bucket, T + bucket, bucket)
                     if mix["frame_low"] <= T - b <= mix["frame_high"]} | {mix["frame_low"]}):
        _reseed(state, 0, f)
    state.outputs.clear()
    state.log.clear()
    return state


def _gt(state, s, f):
    """The ground-truth patch over frame f of session s (the annotator)."""
    T, N, h, w, oh, ow = state.geo
    x0 = s["x0"] + f * (w - ow)
    return state.seg[:N * (h - oh) + oh, x0:x0 + w]


def _frame(state, i):
    while len(state.schedule) <= i:
        state.schedule.append(int(state.frames.integers(state.mix["frame_low"],
                                                         state.mix["frame_high"] + 1)))
    return state.schedule[i]


def _reseed(state, si, f):
    s = state.sessions[si]
    before = s["map"]
    with span("reseed.call"):
        after = s["pipe"].reseed(_gt(state, s, f), f, bucket=state.mix["bucket"]).prediction
    s["map"] = after
    return before, after


def request(state, i):
    si, f = i % len(state.sessions), _frame(state, i)
    before, after = _reseed(state, si, f)
    state.outputs.append((si, f, before, after))
    cfg = state.config
    T, N = state.geo[:2]
    p = cfg["propagation"]
    ops, bound = 0, 0.0
    for t in range(1, T - f):
        o, b = arith.step_flops_bytes(1 + p["cxt_size"], N, cfg["embed_dim"], cfg["nclasses"],
                                      p["knn"], 1 + min(t, p["cxt_size"]))
        ops += o
        bound += arith.bound_seconds(o, b)
    state.log.append({"flops": ops, "prop_bound_s": bound})
    return 1


def finish(state):
    common.synchronize(state.device)


def counters(state):
    return {"prop_launches": common.launches()}


def _embeddings(state, precise=True):
    T, N, h, w, oh, ow = state.geo
    cfg = state.config
    rg = state.rg
    if cfg.get("trim_splits"):
        rg = ref_survey.trim(rg, cfg["trim_splits"], T, w)
    rg = torch.as_tensor(rg, device=state.device)
    patches = ref.windows(rg, [s["x0"] for s in state.sessions], T, N, (h, w), (oh, ow))
    return common.reference_embed(state.sd, patches, precise)


def _soft_by_frame(state, emb, frames, precise=True):
    """{f: soft (S, T - f, N, M)} for every session reseeded at f."""
    N = state.geo[1]
    out = {}
    for f in sorted(frames):
        seeds = torch.as_tensor(np.stack([ref.seed_labels(_gt(state, s, f), N)
                                          for s in state.sessions]), device=emb.device)
        with common.tf32(not precise):
            out[f] = ref.propagate(emb[:, f:], seeds, **common.prop_args(state.config))
    return out


def _numbers(state, outputs, soft, limits):
    tot, splice = [0, 0], 0
    for si, f, before, after in outputs:
        cls = torch.as_tensor(np.ascontiguousarray(after[:, f:].T), device=soft[f].device)
        tot = [a + b for a, b in zip(tot, ref.disagreements(soft[f][si], cls))]
        splice += int((after[:, :f] != before[:, :f]).sum())
    if not outputs:
        splice = float("inf")
        tot = [float("inf"), 1]
    return [("class_disagree", float(tot[0] / tot[1]), limits.get("class_disagree")),
            ("splice_mismatches", float(splice), limits.get("splice_mismatches"))]


def check(state, limits):
    outputs = list(state.outputs)
    for s in state.sessions:
        s.pop("pipe", None)
    common.release(state, "model")
    emb = _embeddings(state)
    return _numbers(state, outputs, _soft_by_frame(state, emb, {f for _, f, _, _ in outputs}),
                    limits)


def control(state, limits, n: int):
    """The reference in TF32 in the program's place for requests 0..n-1,
    spliced into the maps that the program's set-up left."""
    for s in state.sessions:
        s.pop("pipe", None)
    common.release(state, "model")
    frames = {_frame(state, i) for i in range(n)}
    lo = _soft_by_frame(state, _embeddings(state, precise=False), frames, precise=False)
    outputs = []
    for i in range(n):
        si, f = i % len(state.sessions), _frame(state, i)
        s = state.sessions[si]
        before = s["map"]
        after = before.copy()
        after[:, f:] = lo[f][si].argmax(-1).T.cpu().numpy()
        s["map"] = after
        outputs.append((si, f, before, after))
    emb = _embeddings(state)
    return _numbers(state, outputs, _soft_by_frame(state, emb, frames), limits)
