"""Single-radargram qualitative test + change-point correction (the port of
scripts/test.py).

    python -m radar_sounder_crw_tpu_torch.cli.test --dataset 3 ...

Propagates from a first-frame seed, plots, then re-propagates a shorter
window from the change point (fallback seq_length-2) and splices it in.
"""

from __future__ import annotations

import argparse
import os

from ._common import add_device_args, ensure_dirs, load_encoder, normalize_pair


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Test", add_help=True)
    parser.add_argument("--model", default=1, type=int, help="0=CNN,1=ResNet18")
    parser.add_argument("--dataset", default=3, type=int)
    parser.add_argument("--patch_size", default=(16, 16), nargs="+", type=int)
    parser.add_argument("--seq_length", default=80, type=int)
    parser.add_argument("--overlap", default=(8, 0), nargs="+", type=int)
    parser.add_argument("-c", "--cxt_size", default=80, type=int)
    parser.add_argument("-r", "--radius", default=16, type=int)
    parser.add_argument("-t", "--temp", default=0.01, type=float)
    parser.add_argument("-k", "--knn", default=10, type=int)
    parser.add_argument("--model_path", default="./resources/models/sharad16_3.pt")
    parser.add_argument("--output_folder", default="./resources/output/")
    parser.add_argument("--pos_embed", action="store_true")
    parser.add_argument("--allow_untrained", action="store_true")
    parser.add_argument("--bn_train_mode", action="store_true",
                        help="BatchNorm batch stats at inference (the reference's de-facto behavior)")
    parser.add_argument("--xent_quirk", action="store_true",
                        help="reproduce the reference's channel-shifted xent metric")
    return add_device_args(parser)


def main(args):
    from ..data import create_dataset, get_reference
    from ..infer import (
        PropagationPipeline,
        correction_pixel_offset,
        splice_correction,
    )
    from ..ops import LabelPropConfig
    from ..utils.plotting import plot_segmentation

    patch = normalize_pair(args.patch_size)
    overlap = normalize_pair(args.overlap)
    model = load_encoder(
        args.model, args.pos_embed, args.model_path, args.allow_untrained, args.device
    )

    dataset = create_dataset(
        full=True, id=args.dataset, length=args.seq_length, dim=patch, overlap=overlap
    )
    seq = dataset[0]
    T, N, H, W = seq.shape
    geo = dataset.geo
    rg_len, rg_h = geo.rg_len(), geo.rg_h()

    nclasses, seg = get_reference(
        id=args.dataset, h=N * H, w=0, length=args.seq_length, dim=patch
    )
    pipe = PropagationPipeline(
        model,
        LabelPropConfig(args.cxt_size, args.radius, args.temp, args.knn),
        nclasses=nclasses,
        use_pos_embed=args.pos_embed,
        bn_train_mode=args.bn_train_mode,
        xent_quirk=args.xent_quirk, kernel=args.kernel, device=args.device,
    )

    ensure_dirs(os.path.dirname(args.output_folder.rstrip("/")) or ".")
    os.makedirs(args.output_folder, exist_ok=True)

    seg_ref = seg[:rg_h, :W]
    res = pipe(seq, seg_ref)
    pred_px = pipe.prediction_to_pixels(res.prediction, (seg.shape[0], rg_len))
    plot_segmentation(
        pred_px, save=os.path.join(args.output_folder, "_reco.png"),
        seg=seg[:, :rg_len], dataset=args.dataset,
    )

    # Correction (reference: scripts/test/test.py:72-85)
    change_idx = res.change_idx if res.change_idx is not None else args.seq_length - 2
    change_idx = min(change_idx, args.seq_length - 2)
    print("Correcting at", change_idx)
    small_length = args.seq_length - change_idx
    pixel_offset = correction_pixel_offset(small_length, patch[1], overlap[1])
    small_seq = dataset.get_smaller_item(0, small_length)
    seg_ref2 = seg[:, rg_len - pixel_offset : rg_len - pixel_offset + W]
    corrected = pipe(small_seq, seg_ref2)
    final_px = splice_correction(pred_px, corrected.prediction, pixel_offset)
    plot_segmentation(
        final_px, save=os.path.join(args.output_folder, "_corr.png"),
        seg=seg[:, :rg_len], dataset=args.dataset,
    )
    print("Test done.")
    return final_px


if __name__ == "__main__":
    main(get_args_parser().parse_args())
