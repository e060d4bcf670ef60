"""Entry: batch segmentation of whole flight lines with the upstream CNN
encoder (model id 0), as the batch evaluation runs it with `--model 0
--correction --use_last`.

Request for request what entries/survey.py drives for the ResNet: one
request is one line, a forward `propagate_survey` over all its radargrams
with change detection, the correction passes, the reverse pass and the host
assembly; requests cycle over `lines` lines made from the seed. Set-up loads
the benchmark's CNN weights (portbench/cnn_weights.py) with strict=True
into the port's `create_model(0)` behind the same `PropagationPipeline`.
The request's operations count the CNN's forward (cnn_arith.py) where
survey.py counts the ResNet's. The check compares as survey.py does, with
the reference's embeddings from reference/cnn_infer.py.

Mix keys: lines, correction, use_last, sample (lines the check compares),
trace_seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import arith, cnn_arith, cnn_weights, synth
from portbench.entries import common, survey
from portbench.reference import cnn_infer
from portbench.reference import propagate as ref
from portbench.reference import survey as ref_survey

finish = survey.finish


def setup(ctx):
    from radar_sounder_crw_tpu_torch.data.radargram import RGWindows

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    if cfg["model"] != 0 or cfg["pos_embed"] or cfg["bn_train_mode"]:
        raise ValueError("this entry runs the CNN encoder (model 0) in eval mode, no pos-embed")
    T, N, h, w, oh, ow = common.geometry(cfg)
    seeds = common.child_seeds(ctx.seed, 1 + mix["lines"])
    sd = cnn_weights.state_dict(seeds[0], dev, embed_dim=cfg["embed_dim"])
    lines = []
    for j in range(mix["lines"]):
        rg, seg = synth.radargram(cfg["rows"], cfg["width"], cfg["nclasses"],
                                  seeds[1 + j], dev)
        rg_host, seg_host = rg.cpu().numpy(), seg.to(torch.int32).cpu().numpy()
        del rg, seg
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
    """survey.py's request, its operations recounted with the CNN's forward
    in place of the ResNet's for every patch the passes encoded."""
    R = survey.request(state, i)
    T, N, h, w, oh, ow = state.geo
    out = state.outputs[i]
    frames = T * R * (1 + (out["rev"] is not None)) + sum(s for s, _ in out["corrected"])
    state.log[-1]["flops"] += frames * N * (cnn_arith.encoder_flops(h, w)
                                            - arith.encoder_flops(h, w))
    return R


def counters(state):
    """The propagation launches, and the patches the CNN encoded where the
    port counts them (`encoders.patches`)."""
    from radar_sounder_crw_tpu_torch.models import encoders

    out = survey.counters(state)
    if hasattr(encoders, "patches"):
        out["encode_patches"] = int(encoders.patches["cnn"])
    return out


# -- the check ---------------------------------------------------------------

def _reference_line(state, j, precise=True):
    """The reference's CNN embeddings and the inputs of line j, as
    survey.py's `_reference_line` gives the ResNet's."""
    cfg = state.config
    T, N, h, w, oh, ow = state.geo
    line = state.lines[j]
    rg = ref_survey.trim(line["rg"], cfg["trim_splits"], T, w) if cfg["trim_splits"] else line["rg"]
    rg = torch.as_tensor(rg, device=state.device)
    rg_len = T * (w - ow) + ow
    R = rg.shape[1] // rg_len
    wins = ref.windows(rg, [rg_len * t for t in range(R)], T, N, (h, w), (oh, ow))
    with common.tf32(not precise):
        emb = cnn_infer.embed(state.sd, wins)
    del wins
    return emb, line["seg"], rg_len, R


def check(state, limits):
    done = dict(state.outputs)
    common.release(state, "pipe", "model")
    judged, cache = [], {}
    for i in survey._sample(state, done):
        j = done[i]["line"]
        if j not in cache:
            cache.clear()
            cache[j] = _reference_line(state, j)
        judged.append(survey._judge(state, done[i], *cache[j]))
    return survey._numbers(judged, limits)


def control(state, limits, n: int):
    """The control in the program's place, as survey.py's: the reference in
    TF32 makes the outputs of requests 0..n-1 (argmax classes, its own change
    points and corrections, the same assembly), judged by the full-float32
    reference."""
    common.release(state, "pipe", "model")
    T, N, h, w, oh, ow = state.geo
    judged = []
    for i in range(n):
        j = i % len(state.lines)
        emb_lo, seg, rg_len, R = _reference_line(state, j, precise=False)
        out = {"line": j, "corrected": {}, "rev": None}
        refs = [seg[:N * (h - oh) + oh, rg_len * t: rg_len * t + w] for t in range(R)]
        out["fwd"] = _classes(survey._soft(state, emb_lo, refs, N, False))
        out["change"] = survey._changes(state, emb_lo, False)
        if state.mix["correction"]:
            for t, off, small in ref_survey.corrections(out["change"], T, w, ow):
                c0 = rg_len * t + rg_len - off
                soft = survey._soft(state, emb_lo[t:t + 1, :small], [seg[:, c0:c0 + w]], N, False)
                out["corrected"][(small, t)] = _classes(soft)[0]
        if state.mix["use_last"]:
            seg_rev = ref_survey.flip_blocks(seg, rg_len)
            out["rev"] = _classes(survey._soft(state, emb_lo.flip(1), [
                seg_rev[:, rg_len * t: rg_len * t + w] for t in range(R)], N, False))
        out["final"] = ref_survey.assemble(out["fwd"], out["change"], out["corrected"],
                                           out["rev"], seg.shape[0], T, w, ow,
                                           state.config["merge"]).astype(np.int8)
        del emb_lo
        judged.append(survey._judge(state, out, *_reference_line(state, j)))
    return survey._numbers(judged, limits)


def _classes(soft: torch.Tensor) -> np.ndarray:
    """(B, T, N, M) soft labels -> (B, N, T) int8 best classes on the host."""
    return soft.argmax(-1).transpose(1, 2).to(torch.int8).cpu().numpy()
