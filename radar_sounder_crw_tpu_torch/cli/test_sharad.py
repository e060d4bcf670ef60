"""SHARAD qualitative test: forward pass + fixed change-point correction
(the port of scripts/test_sharad.py: 3 radargrams, the first pre-flipped,
patch 16x16, overlap (8,0), cxt 100 / radius 10 / temp 0.1 / knn 20, change
points overridden to [80, 67, 98], negative xent heatmaps with colorbar).

    python -m radar_sounder_crw_tpu_torch.cli.test_sharad ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ._common import add_device_args, ensure_dirs, load_encoder, normalize_pair
from ._qualitative import (
    forward_pass,
    load_files_or_synth,
    run_corrections,
    save_maps,
    QualitativeSurvey,
)


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Test SHARAD", add_help=True)
    parser.add_argument("--patch_size", default=(16, 16), nargs="+", type=int)
    parser.add_argument("--seq_length", default=100, type=int)
    parser.add_argument("--overlap", default=(8, 0), nargs="+", type=int)
    parser.add_argument("-c", "--cxt_size", default=100, type=int)
    parser.add_argument("-r", "--radius", default=10, type=int)
    parser.add_argument("-t", "--temp", default=0.1, type=float)
    parser.add_argument("-k", "--knn", default=20, type=int)
    parser.add_argument("--change_points", default=(80, 67, 98), nargs="+", type=int)
    parser.add_argument("--model_path", default="./resources/models/sharad16_3.pt")
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
    )
    from ..ops import LabelPropConfig
    from ..utils.plotting import plot_segmentation, pyplot

    plt = pyplot()

    patch, overlap = normalize_pair(args.patch_size), normalize_pair(args.overlap)
    nclasses = 5
    model = load_encoder(1, False, args.model_path, args.allow_untrained, args.device)

    W = args.seq_length * (patch[1] - overlap[1]) + overlap[1]
    rgs, sgs = load_files_or_synth(
        args.input_folder,
        ["s_1.pt", "s_4.pt", "s_3.pt"],
        ["s_1ref.pt", "s_4ref.pt", "s_3ref.pt"],
        nclasses=nclasses,
        synth_hw=(912, W),
        seed0=70,
        flip_first=True,  # reference: test_sharad.py:54,58
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

    fwd_refs = [sgs[t][:rg_h, :Wp] for t in range(len(seqs))]
    seg_list, xent_list, change_list = forward_pass(
        pipe, survey, fwd_refs, (rg_h, rg_len), detect_change=True
    )
    for t in range(len(seqs)):
        plt.imshow(-xent_list[t], cmap="gray")
        plt.gca().set_aspect(xent_list[t].shape[1] / xent_list[t].shape[0] * 0.77)
        plt.colorbar()
        plt.savefig(os.path.join(args.output_folder, f"sharad_xent{t}.png"))
        plt.close()

    print("Predicted change list:", change_list)
    change_list = list(args.change_points)

    print("Correction step", change_list)
    tasks = []  # (t, pixel_offset, change_idx, seg_ref)
    for t, change_idx in enumerate(change_list):
        if change_idx is None:
            continue
        small_length = args.seq_length - change_idx
        pixel_offset = correction_pixel_offset(small_length, patch[1], overlap[1])
        seg_ref = sgs[t][:, rg_len - pixel_offset : rg_len - pixel_offset + Wp]
        tasks.append((t, pixel_offset, change_idx, seg_ref))

    run_corrections(pipe, survey, tasks, seg_list)
    for t, _, _, _ in tasks:
        plot_segmentation(seg_list[t], os.path.join(args.output_folder, f"sharad_res{t}.png"),
                          dataset=3)

    save_maps(os.path.join(args.output_folder, "s_res.npy"), seg_list)
    np.save(os.path.join(args.output_folder, "s_xent.npy"), np.stack(xent_list))
    print("SHARAD test done.")


if __name__ == "__main__":
    main(get_args_parser().parse_args())
