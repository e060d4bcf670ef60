"""Shared helpers of the file-driven qualitative entry points (test_mc1 /
test_mc3 / test_sharad; the port of scripts/_qualitative.py): file loading
with synthetic stand-ins, and the forward / reverse / correction
propagation passes, each one survey call (the JAX scripts' batched
form, whose maps equal their per-radargram form's)."""

from __future__ import annotations

import os

import numpy as np

from ..data import ConcatWindows, RGWindows, load_radargram, synthetic_radargram, unfold2d
from ..infer import splice_correction


def window_radargram(rg: np.ndarray, patch, overlap) -> np.ndarray:
    """(H, W) -> (T, N, h, w), the manual unfold the qualitative scripts use
    (reference: scripts/test/test_mc1.py:67-72)."""
    h, w = patch
    oh, ow = overlap
    grid = unfold2d(np.asarray(rg, np.float32), (h, w), (h - oh, w - ow))
    return np.ascontiguousarray(np.transpose(grid, (1, 0, 2, 3)))


class QualitativeSurvey:
    """The qualitative scripts' radargram set: `seqs` are the host-windowed
    (T, N, h, w) arrays (the entry points read the window shape from
    them), and `source`/`ids` expose the same radargrams as a
    resident-gatherable stack, so the passes upload each radargram ONCE
    and gather windows on the device (PropagationPipeline.propagate_survey)
    instead of uploading the ~h/(h-oh)-times-larger host window stacks."""

    def __init__(self, rgs: list, patch, overlap):
        self.seqs = [window_radargram(r, patch, overlap) for r in rgs]
        shapes = {s.shape for s in self.seqs}
        if len(shapes) != 1:
            raise ValueError(
                f"radargrams window to different shapes {shapes}; they "
                f"cannot be batched"
            )
        T = self.seqs[0].shape[0]
        # one full-width window per radargram: RGWindows with length=T has
        # exactly one start position, and its window 0 is bit-identical to
        # window_radargram (same unfold math, tested)
        self.source = ConcatWindows(
            [RGWindows(r, length=T, dim=patch, overlap=overlap) for r in rgs]
        )
        self.ids = [int(o) for o in self.source._offsets[:-1]]


def load_files_or_synth(
    input_folder: str,
    rg_names: list[str],
    sg_names: list[str],
    nclasses: int,
    synth_hw: tuple[int, int],
    seed0: int = 100,
    flip_first: bool = False,
):
    """Load (radargram, segmentation) file pairs; synthesize deterministic
    stand-ins when the proprietary products are absent."""
    rgs, sgs = [], []
    for i, (rn, sn) in enumerate(zip(rg_names, sg_names)):
        rp, sp = os.path.join(input_folder, rn), os.path.join(input_folder, sn)
        if os.path.exists(rp) and os.path.exists(sp):
            rg, sg = load_radargram(rp), load_radargram(sp).astype(np.int32)
        else:
            print(f"[qualitative] {rn}/{sn} not found; using synthetic stand-in")
            rg, sg = synthetic_radargram(
                H=synth_hw[0], W=synth_hw[1], nclasses=nclasses, seed=seed0 + i
            )
        if flip_first and i == 0:  # reference: test_sharad.py:54,58
            rg, sg = rg[:, ::-1].copy(), sg[:, ::-1].copy()
        rgs.append(np.asarray(rg, np.float32))
        sgs.append(np.asarray(sg, np.int32))
    return rgs, sgs


def forward_pass(pipe, survey, fwd_refs, out_hw, detect_change=False):
    """Forward propagation of every radargram -> (seg_list, xent_list,
    change_list): ONE survey call over the radargram axis with
    DEVICE-RESIDENT window gathering (xent maps returned from the same
    program; change detection on the batched signal when requested).
    survey: a QualitativeSurvey. change_list is [] when detect_change is
    False."""
    if detect_change:
        preds, change_list, xents = pipe.propagate_survey(
            survey.source, survey.ids, fwd_refs, detect_change=True, return_xent=True,
        )
    else:
        preds, xents = pipe.propagate_survey(
            survey.source, survey.ids, fwd_refs, return_xent=True
        )
        change_list = []
    seg_list = [pipe.prediction_to_pixels(p, out_hw) for p in preds]
    return seg_list, list(xents), change_list


def reverse_pass(pipe, survey, rev_refs, out_hw):
    """Reversed-seed propagation -> per-radargram pixel maps, already
    flipped back to original trace order (reference: test_mc1.py:120).
    Gathers from the already-resident radargrams and time-flips on
    device."""
    rpreds = pipe.propagate_survey(survey.source, survey.ids, rev_refs, use_last=True)
    return [pipe.prediction_to_pixels(p, out_hw)[:, ::-1] for p in rpreds]


def run_corrections(pipe, survey, tasks, seg_list):
    """Re-propagate each task's frame tail and splice it into seg_list (in
    place). tasks: (t, pixel_offset, change_idx, seg_ref) per radargram with
    a change point — the tail is frames [change_idx:] (reference:
    scripts/test/test_mc3.py:126). Tasks are grouped by tail length — one
    survey call per distinct T' (the same bucketing as cli.test_all),
    windows gathered on the device at frame offset change_idx from the
    resident radargrams."""
    T = survey.seqs[0].shape[0]
    groups: dict[int, list] = {}
    for task in tasks:
        groups.setdefault(T - task[2], []).append(task)
    for T_small, group in sorted(groups.items()):
        print(f"Correction batch: {len(group)} radargram(s), T'={T_small}")
        preds = pipe.propagate_survey(
            survey.source,
            [survey.ids[g[0]] for g in group],
            [g[3] for g in group],
            length=T_small,
            frame_offsets=[g[2] for g in group],
        )
        for (t, pixel_offset, _, _), pred in zip(group, preds):
            seg_list[t] = splice_correction(seg_list[t], pred, pixel_offset)


def save_maps(path: str, maps) -> None:
    """Save pixel maps stacked, as int32 as the scripts save them (the maps
    are int8 where the classes fit, prediction_to_pixels)."""
    np.save(path, np.stack(maps).astype(np.int32))


def load_refs_or_fallback(
    input_folder: str, names: list[str], fallback_sgs: list[np.ndarray]
):
    """Load auxiliary seed segmentations (e.g. the reverse-pass references,
    reference test_mc1.py:60-62); when a file is absent, fall back to the
    caller's forward reference for that radargram — NEVER to a synthetic
    segmentation, which would be unrelated to the (possibly real) radargram
    it seeds."""
    out = []
    for i, n in enumerate(names):
        p = os.path.join(input_folder, n)
        if os.path.exists(p):
            out.append(np.asarray(load_radargram(p), np.int32))
        else:
            print(
                f"[qualitative] {n} not found; seeding from the forward "
                f"reference instead"
            )
            out.append(np.asarray(fallback_sgs[i], np.int32))
    return out
