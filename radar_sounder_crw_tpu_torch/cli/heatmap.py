"""Paper-figure generator: radargram crop, horizontality xent heatmap,
rolling image/metric means, PELT change point (the port of
scripts/heatmap.py: 4-panel PDF/PNG, Pelt pen=2).

    python -m radar_sounder_crw_tpu_torch.cli.heatmap ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ._common import add_device_args, ensure_dirs, load_encoder, normalize_pair
from ._qualitative import window_radargram


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Heatmap", add_help=True)
    parser.add_argument("--model", default=1, type=int)
    parser.add_argument("--dataset", default=1, type=int, help="1=Miguel, 3=SHARAD")
    parser.add_argument("--model_path", default="./resources/models/sharad16_3.pt")
    parser.add_argument("--input_folder", default="./resources/input/")
    parser.add_argument("--output_folder", default="./resources/output/")
    parser.add_argument("--patch_size", default=(32, 32), nargs="+", type=int)
    parser.add_argument("--seq_length", default=100, type=int)
    parser.add_argument("--overlap", default=(24, 0), nargs="+", type=int)
    parser.add_argument("--tau", default=0.1, type=float)
    parser.add_argument("--pos_embed", action="store_true")
    parser.add_argument("--allow_untrained", action="store_true")
    # the reference heatmap script computes the metric with the channel-shift
    # quirk AND an untransposed (row-softmax) CE (reference: heatmap.py:52-55);
    # both default ON here for output parity, switchable to the intended form
    parser.add_argument("--no_quirk", action="store_true",
                        help="intended consecutive-frame affinity instead of "
                        "the reference's channel-shifted slicing")
    parser.add_argument("--col_softmax", action="store_true",
                        help="CE over the source axis (like propagate()) "
                        "instead of the reference heatmap's row softmax")
    return add_device_args(parser, kernel=False)


def main(args):
    from ..data import load_radargram, load_raw_pair
    from ..infer.propagate import encode_sequence
    from ..ops import horizontality_xent, pelt_rbf
    from ..utils.plotting import pyplot

    plt = pyplot()
    patch, overlap = normalize_pair(args.patch_size), normalize_pair(args.overlap)
    model = load_encoder(
        args.model, args.pos_embed, args.model_path, args.allow_untrained, args.device
    )

    # crop selection mirrors the reference (heatmap.py:37-40)
    if args.dataset == 1:
        p = os.path.join(args.input_folder, "mc3_1.pt")
        rg = (
            load_radargram(p)
            if os.path.exists(p)
            else load_raw_pair(1)[0]
        )[:1000, :1920]
    else:
        rg = load_raw_pair(3)[0][:, :1920]

    seq = window_radargram(rg, patch, overlap)
    T, N, _, _ = seq.shape
    seq_t = torch.as_tensor(seq, dtype=torch.float32, device=args.device)
    emb = encode_sequence(model, seq_t, args.pos_embed, False)
    xent = horizontality_xent(
        emb,
        args.tau,
        quirk_channel_shift=not args.no_quirk,
        row_softmax=not args.col_softmax,
    ).cpu().numpy()

    fig, ax = plt.subplots(4, 1)
    fig.set_size_inches(13, 13)
    aspect = 0.3

    ax[0].imshow(np.asarray(rg), cmap="gray")
    ax[0].set_ylabel("Time [μs]")
    ax[1].imshow(xent, cmap="gray", interpolation="nearest")
    ax[1].set_ylabel("Time [μs]")

    # block-mean over width-32 chunks; trim the tail so any width works
    block = min(32, rg.shape[1])
    wb = (rg.shape[1] // block) * block
    roll = np.asarray(rg)[:, :wb].reshape(rg.shape[0], -1, block).mean(axis=(0, 2))
    ax[2].plot(roll, "k")
    ax[2].grid()
    ax[2].set_xlim(0, len(roll) - 1)
    ax[2].set_ylabel("Mean")

    rolling = xent.mean(axis=0)
    ax[3].plot(rolling, "k")
    ax[3].grid()
    ax[3].set_xlim(0, len(rolling) - 1)
    ax[3].set_ylabel("Metric")

    for a in ax:
        a.set_xlabel("Trace" if a is ax[0] else "Column")
        span_x = np.diff(a.get_xlim()).item()
        span_y = np.diff(a.get_ylim()).item()
        a.set_aspect(abs(span_x / span_y) * aspect)

    bkps = pelt_rbf(rolling, pen=2.0)
    print("PELT breakpoints (pen=2):", bkps)

    ensure_dirs(args.output_folder)
    plt.tight_layout()
    plt.savefig(os.path.join(args.output_folder, "_heatmap.pdf"), format="pdf",
                dpi=100, bbox_inches="tight")
    plt.savefig(os.path.join(args.output_folder, "_heatmap.png"))
    plt.close()
    print("Heatmap done.")


if __name__ == "__main__":
    main(get_args_parser().parse_args())
