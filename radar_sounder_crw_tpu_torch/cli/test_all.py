"""Full-dataset quantitative evaluation (the port of scripts/test_all.py).

    python -m radar_sounder_crw_tpu_torch.cli.test_all --dataset 1 ...

Propagation of every radargram (stride seq_length), optional change-point
correction (the head variant, or the true tail with --correction_tail),
optional reverse (use_last) pass with the dataset merges, uncertain-class
removal, classification report, confusion matrix and mIoU, wall-clock
timings, and the predicted map as int8 `predicted_map.npy` and
`predicted_map.pt`. Each pass is one survey call
(`PropagationPipeline.propagate_survey`, windows gathered on the device from
the once-uploaded radargram; on a GPU one launch of the whole-sequence
kernel per pass), the corrections one call per bucket of equal length: the
JAX script's batched form, whose maps equal its per-radargram form's. The
reverse pass always sees true seq_length windows (window geometry is
immutable), as on the JAX side. Started by `torch.distributed.run`, each
survey call splits its radargrams over the ranks (one a device); rank 0
alone prints and writes the files.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ._common import add_device_args, ensure_dirs, load_encoder, normalize_pair, process_group


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Test", add_help=True)
    parser.add_argument("--model", default=1, type=int)
    parser.add_argument("--dataset", default=1, type=int, help="0=MCORDS1,1=Miguel,3=SHARAD")
    parser.add_argument("--patch_size", default=(16, 16), nargs="+", type=int)
    parser.add_argument("--seq_length", default=100, type=int)
    parser.add_argument("--overlap", default=(8, 0), nargs="+", type=int)
    parser.add_argument("-c", "--cxt_size", default=100, type=int)
    parser.add_argument("-r", "--radius", default=10, type=int)
    parser.add_argument("-t", "--temp", default=0.1, type=float)
    parser.add_argument("-k", "--knn", default=20, type=int)
    parser.add_argument("--model_path", default="./resources/models/sharad16_3.pt")
    parser.add_argument("--output_folder", default="./resources/output/")
    parser.add_argument("--pos_embed", action="store_true")
    parser.add_argument("--remove_unc", default=True, type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--flip", action="store_true")
    parser.add_argument("--use_last", action="store_true")
    parser.add_argument("--dataset_full", default=True, type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--correction", action="store_true")
    parser.add_argument("--allow_untrained", action="store_true")
    parser.add_argument("--no_plots", action="store_true")
    parser.add_argument("--bn_train_mode", action="store_true",
                        help="BatchNorm batch stats at inference (the reference's de-facto behavior)")
    parser.add_argument("--xent_quirk", action="store_true",
                        help="reproduce the reference's channel-shifted xent metric")
    parser.add_argument("--correction_tail", action="store_true",
                        help="correct with the true tail frames [change_idx:] "
                        "(the mc1/mc3/sharad-style intended semantics) instead "
                        "of the reference test_all behavior of re-propagating "
                        "the HEAD window with a tail seed")
    return add_device_args(parser)


def main(args):
    with process_group(args.device) as lead:
        return _evaluate(args, lead)


def _evaluate(args, lead: bool):
    from ..data import create_dataset, get_reference, save_pt
    from ..infer import (
        PropagationPipeline,
        correction_pixel_offset,
        integrate_flat_mcords3,
        reverse_unfold_flip,
        splice_correction,
    )
    from ..ops import LabelPropConfig, classification_report, confusion_matrix, miou
    from ..utils.plotting import plot_segmentation

    tim = time.time()
    print(args)
    patch = normalize_pair(args.patch_size)
    overlap = normalize_pair(args.overlap)

    model = load_encoder(
        args.model, args.pos_embed, args.model_path, args.allow_untrained, args.device
    )
    dataset = create_dataset(
        id=args.dataset, length=args.seq_length, dim=patch,
        overlap=overlap, full=args.dataset_full, flip=args.flip,
    )
    dummy = dataset[0]
    T, N, H, W = dummy.shape
    nclasses, seg = get_reference(
        id=args.dataset, h=N * H, w=0, flip=args.flip,
        length=args.seq_length, dim=patch,
    )
    lp_cfg = LabelPropConfig(args.cxt_size, args.radius, args.temp, args.knn)
    pipe = PropagationPipeline(
        model, lp_cfg, nclasses, use_pos_embed=args.pos_embed,
        bn_train_mode=args.bn_train_mode, xent_quirk=args.xent_quirk, kernel=args.kernel,
        cache_embeddings=False,  # batch eval never reseeds
        device=args.device,
    )

    geo = dataset.geo
    rg_len, rg_h = geo.rg_len(), geo.rg_h()
    tot_rg = seg.shape[-1] // rg_len
    print("Num of radargrams:", tot_rg, "Radargram length:", rg_len)
    seg = seg[:, : tot_rg * rg_len]

    rg_idx_list = (
        list(range(0, len(dataset), args.seq_length))
        if args.dataset_full
        else list(range(tot_rg))
    )
    print("\nList of items picked from the dataset:", rg_idx_list, "\n")
    plots = lead and not args.no_plots
    if lead:
        ensure_dirs(args.output_folder)

    # one survey call: the radargram is uploaded once and the windows are
    # gathered on the device; change detection runs on the batched xent,
    # PELT on the host per radargram
    seg_refs = [seg[:rg_h, rg_len * t : rg_len * t + W] for t in range(len(rg_idx_list))]
    preds, change_list = pipe.propagate_survey(dataset, rg_idx_list, seg_refs, detect_change=True)
    seg_list = []
    for t in range(len(rg_idx_list)):
        pred_px = pipe.prediction_to_pixels(preds[t], (seg.shape[0], rg_len))
        if plots:
            plot_segmentation(
                pred_px,
                save=os.path.join(args.output_folder, f"im{t}.png"),
                seg=seg[:, rg_len * t : rg_len * t + rg_len],
                dataset=args.dataset,
            )
        seg_list.append(pred_px)

    if args.correction:
        print("\nCorrection step")
        print("Change point for each radargram:", change_list)
        # (t, pixel_offset, small_length, frame_offset, seg_ref): the head
        # window of small_length frames at offset 0, or the true tail at
        # offset change_idx; frames and windows share the (w-ow) column stride
        tasks = []
        for t, change_idx in enumerate(change_list):
            if change_idx is None or change_idx >= args.seq_length - 1:
                continue
            try:
                small_length = args.seq_length - change_idx
                pixel_offset = correction_pixel_offset(small_length, patch[1], overlap[1])
                frame_off = change_idx if args.correction_tail else 0
                c0 = rg_len * t + rg_len - pixel_offset
                tasks.append(
                    (t, pixel_offset, small_length, frame_off, seg[:, c0 : c0 + W])
                )
            except Exception as e:  # one radargram's failure leaves the others
                print(f"  correction prep failed for radargram {t}: {e}")

        def apply_correction(t, pixel_offset, pred):
            seg_list[t] = splice_correction(seg_list[t], pred, pixel_offset)
            if plots:
                plot_segmentation(
                    seg_list[t],
                    save=os.path.join(args.output_folder, f"im{t}c.png"),
                    seg=seg[:, rg_len * t : rg_len * t + rg_len],
                    dataset=args.dataset,
                )

        # one survey call per distinct correction length, windows gathered
        # from the already-resident radargram
        groups: dict[int, list] = {}
        for task in tasks:
            groups.setdefault(task[2], []).append(task)
        for T_small, group in sorted(groups.items()):
            print(f"Correction batch: {len(group)} radargram(s), T'={T_small}")
            try:
                preds = pipe.propagate_survey(
                    dataset,
                    [rg_idx_list[g[0]] for g in group],
                    [g[4] for g in group],
                    length=T_small,
                    frame_offsets=[g[3] for g in group],
                )
                for (t, pixel_offset, _, _, _), pred in zip(group, preds):
                    apply_correction(t, pixel_offset, pred)
            except Exception as e:
                print(f"  correction batch failed: {e}")

    final_pred = np.concatenate(seg_list, axis=1)
    if lead:
        np.save(os.path.join(args.output_folder, "predicted_map.npy"),
                final_pred.astype(np.int8))
        save_pt(
            os.path.join(args.output_folder, "predicted_map.pt"),
            final_pred.astype(np.int8),
        )
    final_flat = final_pred.ravel()
    gt_flat = seg.ravel()

    if args.use_last:
        print("Reversed step\n")
        seg_rev = reverse_unfold_flip(seg, rg_len)
        rev_seg_refs = [
            seg_rev[:, rg_len * t : rg_len * t + W]
            for t in range(len(rg_idx_list))
        ]
        # the forward pass's survey call with the time flip on the device
        rev_preds = pipe.propagate_survey(dataset, rg_idx_list, rev_seg_refs, use_last=True)
        rev_list = [pipe.prediction_to_pixels(p, (seg.shape[0], rg_len)) for p in rev_preds]
        rev_map = reverse_unfold_flip(np.concatenate(rev_list, axis=1), rg_len)
        if args.dataset in (0, 3):
            mask = rev_map.ravel() == 2
            if args.dataset == 3:
                mask[: len(mask) // 2] = False
            final_flat = final_flat.copy()
            final_flat[mask] = 2
        elif args.dataset == 1:
            final_flat = integrate_flat_mcords3(final_flat, rev_map)

    if args.remove_unc:
        if args.dataset == 0:
            _, unc_seg = get_reference(id=2, h=N * H, w=0, flip=args.flip)
            unc_seg = unc_seg[:, : tot_rg * rg_len]
            mask = (unc_seg != 4).ravel()
            gt, pred = gt_flat[mask], final_flat[mask]
        elif args.dataset == 1:
            mask = (gt_flat != 5) & (final_flat != 5)
            gt, pred = gt_flat[mask], final_flat[mask]
        else:
            gt, pred = gt_flat, final_flat
    else:
        gt, pred = gt_flat, final_flat

    print("Time elapsed (inference only):", time.time() - tim)
    print("Computing reports ...\n")
    ncls_report = max(nclasses, int(gt.max()) + 1, int(pred.max()) + 1)
    print(classification_report(gt, pred, ncls_report))
    cm = confusion_matrix(gt, pred, ncls_report)
    print(cm)
    print("mIoU:", miou(cm))
    print("\nTime elapsed (inference + metrics):", time.time() - tim)
    return final_pred


if __name__ == "__main__":
    main(get_args_parser().parse_args())
