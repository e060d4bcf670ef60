"""Driver: batch segmentation of whole flight lines, as the upstream batch
evaluation runs it (`test_all --batched --correction --use_last`).

One request is one line: a forward `propagate_survey` over all its
radargrams with change detection, the correction passes (one survey call per
distinct corrected length, the head windows re-seeded at the change point),
the reverse pass (`use_last`) and the host assembly of the line's pixel map
(nearest resizes, splices, the flip back, the merge). mIoU, plots and files
are left out. Requests cycle over `lines` lines made from the seed, so no
request finds its line already on the device.

Mix keys: lines, correction, use_last, sample (lines the check compares),
trace_seconds.
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
    seeds = common.child_seeds(ctx.seed, 1 + mix["lines"])
    lines = []
    for j in range(mix["lines"]):
        rg, seg = synth.radargram(cfg["rows"], cfg["width"], cfg["nclasses"],
                                  seeds[1 + j], dev)
        if j == 0:
            sd = common.make_weights(cfg, seeds[0], dev, rg)
        rg_host, seg_host = rg.cpu().numpy(), seg.to(torch.int32).cpu().numpy()
        if cfg["trim_splits"]:
            seg_host = ref_survey.trim(seg_host, cfg["trim_splits"], T, w)
        ds = RGWindows(rg_host, length=T, dim=(h, w), overlap=(oh, ow),
                       trim_miguel_splits=bool(cfg["trim_splits"]))
        lines.append({"rg": rg_host, "seg": seg_host, "dataset": ds})
    model = common.program_encoder(cfg, sd, dev)
    pipe = common.pipeline(cfg, model, dev, cache_embeddings=False)
    state = common.State(config=cfg, mix=mix, device=dev, seed=ctx.seed, sd=sd, model=model,
                         pipe=pipe, lines=lines, outputs={}, geo=(T, N, h, w, oh, ow))
    for j in range(len(lines)):  # every line once: every shape the window meets
        request(state, j)
    state.log.clear()
    state.outputs.clear()
    return state


def request(state, i):
    cfg, mix = state.config, state.mix
    T, N, h, w, oh, ow = state.geo
    line = state.lines[i % len(state.lines)]
    ds, seg = line["dataset"], line["seg"]
    geo = ds.geo
    rg_len, rg_h = geo.rg_len(), geo.rg_h()
    H = seg.shape[0]
    R = seg.shape[1] // rg_len
    ids = list(range(0, R * T, T))
    work = {"flops": 0, "prop_bound_s": 0.0}

    def count(B, L, xent):
        ops, nbytes = arith.seq_flops_bytes(B, L, N, cfg["embed_dim"], cfg["nclasses"],
                                            cfg["propagation"]["knn"], 1,
                                            cfg["propagation"]["cxt_size"])
        work["flops"] += B * L * N * arith.encoder_flops(h, w) + ops
        work["flops"] += arith.xent_flops(B, L, N, cfg["embed_dim"]) if xent else 0
        work["prop_bound_s"] += arith.bound_seconds(ops, nbytes)

    with span("survey.forward"):
        refs = [seg[:rg_h, rg_len * t: rg_len * t + w] for t in range(R)]
        fwd, change = state.pipe.propagate_survey(ds, ids, refs, detect_change=True)
    count(R, T, True)
    out = {"line": i % len(state.lines), "fwd": fwd.astype(np.int8), "change": list(change),
           "corrected": {}, "rev": None}
    if mix["correction"]:
        groups: dict = {}
        for t, c in enumerate(change):
            if c is None or c >= T - 1:
                continue
            small = T - c
            off = small * (w - ow)
            c0 = rg_len * t + rg_len - off
            groups.setdefault(small, []).append((t, seg[:, c0:c0 + w]))
        with span("survey.correction"):
            for small, group in sorted(groups.items()):
                preds = state.pipe.propagate_survey(
                    ds, [ids[t] for t, _ in group], [g for _, g in group], length=small,
                    frame_offsets=[0] * len(group))
                count(len(group), small, False)
                for (t, _), p in zip(group, preds):
                    out["corrected"][(small, t)] = p.astype(np.int8)
    if mix["use_last"]:
        with span("survey.reverse"):
            seg_rev = ref_survey.flip_blocks(seg, rg_len)
            rev = state.pipe.propagate_survey(
                ds, ids, [seg_rev[:, rg_len * t: rg_len * t + w] for t in range(R)], use_last=True)
        count(R, T, False)
        out["rev"] = rev.astype(np.int8)
    with span("survey.assemble"):
        out["final"] = _assemble(state, out, H, rg_len)
    state.outputs[i] = out
    state.log.append(work)
    return R


def _assemble(state, out, H, rg_len):
    """The line's map by the program's own host functions, as the batch
    evaluation assembles it."""
    from radar_sounder_crw_tpu_torch.infer import (
        correction_pixel_offset,
        integrate_flat_mcords3,
        reverse_unfold_flip,
        splice_correction,
    )

    T, N, h, w, oh, ow = state.geo
    px = [state.pipe.prediction_to_pixels(f, (H, rg_len)) for f in out["fwd"]]
    for (small, t), pred in out["corrected"].items():
        px[t] = splice_correction(px[t], pred, correction_pixel_offset(small, w, ow))
    final = np.concatenate(px, axis=1).ravel()
    if out["rev"] is not None:
        rev_px = [state.pipe.prediction_to_pixels(r, (H, rg_len)) for r in out["rev"]]
        final = integrate_flat_mcords3(final, reverse_unfold_flip(
            np.concatenate(rev_px, axis=1), rg_len))
    return final.astype(np.int8)


def finish(state):
    common.synchronize(state.device)


def counters(state):
    return {"prop_launches": common.launches()}


# -- the check ---------------------------------------------------------------

def _reference_line(state, j, precise=True):
    """The reference's embeddings and inputs of line j."""
    cfg = state.config
    T, N, h, w, oh, ow = state.geo
    line = state.lines[j]
    rg = ref_survey.trim(line["rg"], cfg["trim_splits"], T, w) if cfg["trim_splits"] else line["rg"]
    rg = torch.as_tensor(rg, device=state.device)
    rg_len = T * (w - ow) + ow
    R = rg.shape[1] // rg_len
    wins = ref.windows(rg, [rg_len * t for t in range(R)], T, N, (h, w), (oh, ow))
    emb = common.reference_embed(state.sd, wins, precise)
    del wins
    return emb, line["seg"], rg_len, R


def _soft(state, emb, seg_cols, N, precise=True):
    seeds = torch.as_tensor(np.stack([ref.seed_labels(s, N) for s in seg_cols]),
                            device=emb.device)
    with common.tf32(not precise):
        return ref.propagate(emb, seeds, **common.prop_args(state.config))


def _changes(state, emb, precise=True):
    from portbench.reference import pelt

    with common.tf32(not precise):
        sig = ref.change_signal(ref.xent_map(emb, state.config["xent_tau"])).cpu().numpy()
    if emb.shape[1] < 4:
        return [None] * emb.shape[0]
    return [pelt.detect_change_point(s, pen=state.config["pelt_pen"]) for s in sig]


def _judge(state, out, emb, seg, rg_len, R):
    """((patch-map entries off the reference's best class, entries), change
    point mismatches, pixels of the line's map off the reference's
    assembly) of one request's outputs."""
    T, N, h, w, oh, ow = state.geo
    mix = state.mix
    H = seg.shape[0]
    rg_h = N * (h - oh) + oh
    soft = _soft(state, emb, [seg[:rg_h, rg_len * t: rg_len * t + w] for t in range(R)], N)
    dis = [ref.disagreements(soft, torch.as_tensor(out["fwd"], device=emb.device)
                             .transpose(1, 2))]
    change = _changes(state, emb)
    mism = sum(a != b for a, b in zip(change, out["change"]))
    mism += abs(len(change) - len(out["change"]))
    for t, off, small in ref_survey.corrections(out["change"], T, w, ow):
        if (small, t) not in out["corrected"]:
            continue  # assemble() below counts the missing correction
        c0 = rg_len * t + rg_len - off
        soft = _soft(state, emb[t:t + 1, :small], [seg[:, c0:c0 + w]], N)
        dis.append(ref.disagreements(soft, torch.as_tensor(
            out["corrected"][(small, t)], device=emb.device).T[None]))
    if mix["use_last"]:
        seg_rev = ref_survey.flip_blocks(seg, rg_len)
        soft = _soft(state, emb.flip(1), [seg_rev[:, rg_len * t: rg_len * t + w]
                                         for t in range(R)], N)
        dis.append(ref.disagreements(soft, torch.as_tensor(
            out["rev"], device=emb.device).transpose(1, 2)))
    try:
        final = ref_survey.assemble(out["fwd"], out["change"], out["corrected"], out["rev"], H, T,
                                    w, ow, state.config["merge"])
        map_mism = int((final != out["final"]).sum()) if final.shape == out["final"].shape \
            else int(final.size)
    except KeyError:
        map_mism = H * R * rg_len
    return (sum(d for d, _ in dis), sum(n for _, n in dis)), mism, map_mism


def _numbers(judged, lim):
    if not judged:
        judged = [((np.inf, 1), np.inf, np.inf)]
    dis, mism, maps = zip(*judged)
    return [("class_disagree", float(sum(d for d, _ in dis) / sum(n for _, n in dis)),
             lim.get("class_disagree")),
            ("change_mismatches", float(sum(mism)), lim.get("change_mismatches")),
            ("map_mismatches", float(sum(maps)), lim.get("map_mismatches"))]


def _sample(state, done):
    rng = np.random.default_rng([state.seed, 1])
    k = min(state.mix["sample"], len(done))
    return sorted(rng.choice(sorted(done), size=k, replace=False).tolist()) if k else []


def check(state, limits):
    done = dict(state.outputs)
    common.release(state, "pipe", "model")
    judged, cache = [], {}
    for i in _sample(state, done):
        j = done[i]["line"]
        if j not in cache:
            cache.clear()
            cache[j] = _reference_line(state, j)
        judged.append(_judge(state, done[i], *cache[j]))
    return _numbers(judged, limits)


def control(state, limits, n: int):
    """The control in the program's place: the reference in TF32 makes the
    outputs of requests 0..n-1 (argmax classes, its own change points and
    corrections, the same assembly), judged by the full-float32 reference."""
    common.release(state, "pipe", "model")
    T, N, h, w, oh, ow = state.geo
    judged = []
    for i in range(n):
        j = i % len(state.lines)
        emb_lo, seg, rg_len, R = _reference_line(state, j, precise=False)
        out = {"line": j, "corrected": {}, "rev": None}
        refs = [seg[:N * (h - oh) + oh, rg_len * t: rg_len * t + w] for t in range(R)]
        out["fwd"] = _soft(state, emb_lo, refs, N, False).argmax(-1).transpose(1, 2) \
            .to(torch.int8).cpu().numpy()
        out["change"] = _changes(state, emb_lo, False)
        if state.mix["correction"]:
            for t, off, small in ref_survey.corrections(out["change"], T, w, ow):
                c0 = rg_len * t + rg_len - off
                soft = _soft(state, emb_lo[t:t + 1, :small], [seg[:, c0:c0 + w]], N, False)
                out["corrected"][(small, t)] = soft[0].argmax(-1).T.to(torch.int8).cpu().numpy()
        if state.mix["use_last"]:
            seg_rev = ref_survey.flip_blocks(seg, rg_len)
            soft = _soft(state, emb_lo.flip(1), [seg_rev[:, rg_len * t: rg_len * t + w]
                                                 for t in range(R)], N, False)
            out["rev"] = soft.argmax(-1).transpose(1, 2).to(torch.int8).cpu().numpy()
        out["final"] = ref_survey.assemble(out["fwd"], out["change"], out["corrected"],
                                           out["rev"], seg.shape[0], T, w, ow,
                                           state.config["merge"]).astype(np.int8)
        del emb_lo
        judged.append(_judge(state, out, *_reference_line(state, j)))
    return _numbers(judged, limits)
