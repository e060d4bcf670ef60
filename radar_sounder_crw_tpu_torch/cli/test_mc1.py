"""MCoRDS1 qualitative test: forward + reverse propagation with
bidirectional integration (the port of scripts/test_mc1.py: 3 radargrams,
patch 32x32, overlap (24,0), cxt 80 / radius 30 / temp 0.1 / knn 20,
use_last integration with bedrock and noise override masks, xent heatmap
figures).

    python -m radar_sounder_crw_tpu_torch.cli.test_mc1 ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ._common import add_device_args, ensure_dirs, load_encoder, normalize_pair
from ._qualitative import (
    forward_pass,
    load_files_or_synth,
    load_refs_or_fallback,
    reverse_pass,
    save_maps,
    QualitativeSurvey,
)


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Test MC1", add_help=True)
    parser.add_argument("--patch_size", default=(32, 32), nargs="+", type=int)
    parser.add_argument("--seq_length", default=100, type=int)
    parser.add_argument("--overlap", default=(24, 0), nargs="+", type=int)
    parser.add_argument("-c", "--cxt_size", default=80, type=int)
    parser.add_argument("-r", "--radius", default=30, type=int)
    parser.add_argument("-t", "--temp", default=0.1, type=float)
    parser.add_argument("-k", "--knn", default=20, type=int)
    parser.add_argument("--use_last", default=True, type=lambda s: s not in ("0", "false", "False"))
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
    from ..infer import PropagationPipeline, integrate_bidirectional
    from ..ops import LabelPropConfig
    from ..utils.plotting import plot_segmentation, plot_xent_heatmap

    patch, overlap = normalize_pair(args.patch_size), normalize_pair(args.overlap)
    nclasses = 4
    model = load_encoder(1, False, args.model_path, args.allow_untrained, args.device)

    W = args.seq_length * (patch[1] - overlap[1]) + overlap[1]
    rgs, sgs = load_files_or_synth(
        args.input_folder,
        ["mc1_1.pt", "mc1_2.pt", "mc1_3.pt"],
        ["mc1_1ref.pt", "mc1_2ref.pt", "mc1_3ref.pt"],
        nclasses=nclasses,
        synth_hw=(410, W),
        seed0=50,
    )
    # backward references: separate files in the reference (test_mc1.py:60-62);
    # when absent, fall back to each radargram's FORWARD reference — not a
    # synthetic segmentation, which would be unrelated to a real radargram
    sgrs = load_refs_or_fallback(
        args.input_folder,
        ["mc1_1ref_r.pt", "mc1_2ref_r.pt", "mc1_3ref_r.pt"],
        sgs,
    )

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
    os.makedirs(args.output_folder, exist_ok=True)

    fwd_refs = [sgs[t][:rg_h, :Wp] for t in range(len(seqs))]
    seg_list, xent_list, _ = forward_pass(pipe, survey, fwd_refs, (rg_h, rg_len))
    for t in range(len(seqs)):
        plot_segmentation(seg_list[t], os.path.join(args.output_folder, f"im{t}.png"),
                          dataset=0, aspect=6)
        plot_xent_heatmap(xent_list[t], os.path.join(args.output_folder, f"im{t}xent.png"))

    if args.use_last:
        print("Reversed step")
        rev_refs = [sgrs[t][:rg_h, :Wp] for t in range(len(seqs))]
        rev_list = reverse_pass(pipe, survey, rev_refs, (rg_h, rg_len))
        final_list = []
        for t in range(len(seqs)):
            plot_segmentation(rev_list[t], os.path.join(args.output_folder, f"im{t}r.png"),
                              dataset=0, aspect=6)
            merged = integrate_bidirectional(seg_list[t], rev_list[t], style="mcords1")
            plot_segmentation(merged, os.path.join(args.output_folder, f"im{t}f.png"),
                              dataset=0, aspect=6)
            final_list.append(merged)
        save_maps(os.path.join(args.output_folder, "mc1_res.npy"), final_list)
    print("MC1 test done.")


if __name__ == "__main__":
    main(get_args_parser().parse_args())
