"""Supervised UNet baseline on SHARAD strips (the port of
scripts/test_unet.py): width-64 full-height strips, one-hot ground truth,
90/10 random split, Adam lr 1e-4, batch 64, 100 epochs by default, then the
classification report, the confusion matrix and `mIoU:` on the held-out
strips. The reference's softmax-then-cross-entropy quirk is kept by
default; --no_quirk trains with standard CE. Besides the script's flags:
`--device` (default cuda). Started by `torch.distributed.run`, training
and the held-out maps are data parallel over the ranks; rank 0 alone
prints.

    python -m radar_sounder_crw_tpu_torch.cli.test_unet [--epochs 5] [--bf16]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ._common import add_device_args, normalize_pair, process_group


def get_args_parser():
    parser = argparse.ArgumentParser("UNet train and test on SHARAD dataset", add_help=True)
    parser.add_argument("--patch_size", default=(912, 64), nargs="+", type=int)
    parser.add_argument("--split", default=0.9, type=float)
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--no_quirk", action="store_true",
                        help="standard CE instead of the double-softmax quirk")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--seed", default=11, type=int)
    return add_device_args(parser, kernel=False)


def main(args):
    with process_group(args.device):
        return _run(args)


def _run(args):
    from ..data import load_raw_pair
    from ..parallel import default_mesh
    from ..ops import classification_report, confusion_matrix, miou
    from ..train.unet_trainer import (
        UNetTrainConfig,
        UNetTrainer,
        train_test_split,
        unfold_strips,
    )

    print(args)
    patch = normalize_pair(args.patch_size)
    rg, sg = load_raw_pair(3)  # real SHARAD when present, synthetic otherwise
    sg = sg.astype(np.int32)
    n_classes = 5

    x, y = unfold_strips(rg, sg, strip_w=patch[1], n_classes=n_classes)
    tr_idx, te_idx = train_test_split(len(x), args.split, args.seed)

    cfg = UNetTrainConfig(
        patch_size=patch,
        split=args.split,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        n_classes=n_classes,
        seed=args.seed,
        quirk_double_softmax=not args.no_quirk,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )
    trainer = UNetTrainer(cfg, mesh=default_mesh(args.device))
    trainer.fit(x[tr_idx], y[tr_idx])

    preds, refs = [], []
    for s in range(0, len(te_idx), cfg.batch_size):
        idx = te_idx[s: s + cfg.batch_size]
        preds.append(trainer.predict(x[idx]).ravel())
        refs.append(y[idx].argmax(-1).ravel())
    p, t = np.concatenate(preds), np.concatenate(refs)
    print(classification_report(t, p, n_classes))
    cm = confusion_matrix(t, p, n_classes)
    print(cm)
    print("mIoU:", miou(cm))
    return trainer


if __name__ == "__main__":
    main(get_args_parser().parse_args())
