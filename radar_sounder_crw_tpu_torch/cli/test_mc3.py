"""MCoRDS3 qualitative test: forward pass, fixed change-point correction,
reverse pass, floating-ice-guarded integration (the port of
scripts/test_mc3.py: patch 32x32, overlap (30,0), cxt 100 / radius 60 /
temp 0.01 / knn 20, change points overridden to [38, 36, 52], correction
re-propagates the frame tail rg[t][change_idx:]).

    python -m radar_sounder_crw_tpu_torch.cli.test_mc3 ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ._common import add_device_args, ensure_dirs, load_encoder, normalize_pair
from ._qualitative import (
    QualitativeSurvey,
    forward_pass,
    load_files_or_synth,
    reverse_pass,
    save_maps,
    run_corrections,
)


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Test MC3", add_help=True)
    parser.add_argument("--patch_size", default=(32, 32), nargs="+", type=int)
    parser.add_argument("--seq_length", default=100, type=int)
    parser.add_argument("--overlap", default=(30, 0), nargs="+", type=int)
    parser.add_argument("-c", "--cxt_size", default=100, type=int)
    parser.add_argument("-r", "--radius", default=60, type=int)
    parser.add_argument("-t", "--temp", default=0.01, type=float)
    parser.add_argument("-k", "--knn", default=20, type=int)
    parser.add_argument("--correction", default=True, type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--use_last", default=True, type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--change_points", default=(38, 36, 52), nargs="+", type=int,
                        help="fixed change points (reference hardcodes [38,36,52])")
    parser.add_argument("--model_path", default="./resources/models/latestx.pt")
    parser.add_argument("--input_folder", default="./resources/input/")
    parser.add_argument("--output_folder", default="./resources/output/")
    parser.add_argument("--allow_untrained", action="store_true")
    parser.add_argument("--bn_train_mode", action="store_true",
                        help="BatchNorm batch stats at inference (the reference's de-facto behavior)")
    parser.add_argument("--xent_quirk", action="store_true",
                        help="reproduce the reference's channel-shifted xent metric")
    return add_device_args(parser)


def main(args):
    from ..infer import (
        PropagationPipeline,
        correction_pixel_offset,
        integrate_bidirectional,
    )
    from ..ops import LabelPropConfig
    from ..utils.plotting import plot_segmentation, plot_xent_heatmap

    patch, overlap = normalize_pair(args.patch_size), normalize_pair(args.overlap)
    nclasses = 5
    model = load_encoder(1, False, args.model_path, args.allow_untrained, args.device)

    W = args.seq_length * (patch[1] - overlap[1]) + overlap[1]
    rgs, sgs = load_files_or_synth(
        args.input_folder,
        ["mc3_1.pt", "mc3_2.pt", "mc3_3y.pt"],
        ["mc3_1ref.pt", "mc3_2ref.pt", "mc3_3refy.pt"],
        nclasses=6,
        synth_hw=(512, W),
        seed0=60,
    )
    # reference GT patch-fix (test_mc3.py:61)
    if sgs[1].shape[0] > 900 and sgs[1].shape[1] > 1200:
        sgs[1][870:900, 1132:1200] = 2

    survey = QualitativeSurvey(rgs, patch, overlap)
    seqs = survey.seqs
    T, N, H, Wp = seqs[0].shape
    rg_len = T * (Wp - overlap[1]) + overlap[1]
    rg_h = N * (H - overlap[0]) + overlap[0]
    print("Num of radargrams:", len(seqs), "Radargram length:", rg_len)

    pipe = PropagationPipeline(
        model,
        LabelPropConfig(args.cxt_size, args.radius, args.temp, args.knn),
        nclasses=nclasses, bn_train_mode=args.bn_train_mode,
        xent_quirk=args.xent_quirk, kernel=args.kernel, device=args.device,
    )
    ensure_dirs(args.output_folder)

    fwd_refs = [sgs[t][:rg_h, :Wp] for t in range(len(seqs))]
    seg_list, xent_list, change_list = forward_pass(
        pipe, survey, fwd_refs, (rg_h, rg_len), detect_change=True
    )
    for t in range(len(seqs)):
        plot_segmentation(seg_list[t], os.path.join(args.output_folder, f"jim{t}.png"), dataset=1)
        plot_xent_heatmap(xent_list[t], os.path.join(args.output_folder, f"jim{t}xent.png"),
                          colorbar=True)

    print("Detected change points:", change_list)
    change_list = list(args.change_points)  # reference override (test_mc3.py:111-113)

    if args.correction:
        print("Correction step", change_list)
        tasks = []  # (t, pixel_offset, change_idx, seg_ref)
        for t, change_idx in enumerate(change_list):
            if change_idx is None:
                continue
            small_length = args.seq_length - change_idx
            pixel_offset = correction_pixel_offset(small_length, patch[1], overlap[1])
            # tail = frames [change_idx:] (reference test_mc3.py:126)
            seg_ref = sgs[t][:, rg_len - pixel_offset : rg_len - pixel_offset + Wp]
            tasks.append((t, pixel_offset, change_idx, seg_ref))

        run_corrections(pipe, survey, tasks, seg_list)
        for t, _, _, _ in tasks:
            plot_segmentation(seg_list[t], os.path.join(args.output_folder, f"jim{t}c.png"),
                              dataset=1)
    save_maps(os.path.join(args.output_folder, "mc3_res.npy"), seg_list)

    if args.use_last:
        print("Reversed step")
        rev_refs = [sgs[t][:rg_h, -Wp:] for t in range(len(seqs))]  # seed: LAST cols
        rev_list = reverse_pass(pipe, survey, rev_refs, (rg_h, rg_len))
        final_list = []
        for t in range(len(seqs)):
            plot_segmentation(rev_list[t], os.path.join(args.output_folder, f"jim{t}r.png"),
                              dataset=1)
            merged = integrate_bidirectional(seg_list[t], rev_list[t], style="mcords3")
            plot_segmentation(merged, os.path.join(args.output_folder, f"jim{t}x.png"),
                              dataset=1)
            final_list.append(merged)
        save_maps(os.path.join(args.output_folder, "mc3_resy.npy"), final_list)
        np.save(os.path.join(args.output_folder, "mc3_xenty.npy"), np.stack(xent_list))
    print("MC3 test done.")


if __name__ == "__main__":
    main(get_args_parser().parse_args())
