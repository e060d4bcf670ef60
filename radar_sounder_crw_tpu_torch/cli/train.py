"""CRW unsupervised training (the port of scripts/train.py): the same flags
and defaults, the same printed lines (parameter count, one line per epoch,
`Saved encoder to ...`, `Finished training.`), the encoder written as a
reference-layout `.pt`, and `--ckpt_dir`/`--resume` through torch
checkpoints. Besides the script's flags: `--device` (default cuda) and
`--no_plots` (skip `output/_loss.png`). Not ported: the `--tune*` family
(ASHA) and `--steps_per_dispatch` (TPU only).

    python -m radar_sounder_crw_tpu_torch.cli.train --dataset 3 --model 1 [--bf16] ...
"""

from __future__ import annotations

import argparse
import os

import torch

from ._common import add_device_args, ensure_dirs, normalize_pair


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Train", add_help=True)
    parser.add_argument("--model", default=1, type=int, help="0=CNN,1=ResNet18")
    parser.add_argument("--dataset", default=3, type=int, help="0=MCORDS1,1=Miguel,3=SHARAD")
    parser.add_argument("--patch_size", default=(16, 16), nargs="+", type=int)
    parser.add_argument("--seq_length", default=20, type=int)
    parser.add_argument("--overlap", default=(8, 0), nargs="+", type=int)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--epochs", default=2, type=int)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--tau", default=0.01, type=float)
    parser.add_argument("--pos_embed", action="store_true")
    parser.add_argument("--dataset_full", default=True,
                        type=lambda s: s not in ("0", "false", "False"))
    parser.add_argument("--output_folder", default="./resources/")
    parser.add_argument("--output_name", default="sharad16_3")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 encoder compute")
    parser.add_argument("--remat", action="store_true",
                        help="recompute encoder activations in the backward")
    parser.add_argument("--seed", default=11, type=int)
    parser.add_argument("--ckpt_dir", default=None, help="checkpoint dir (enables resume)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the run to this dir")
    parser.add_argument("--no_plots", action="store_true", help="skip the loss-curve PNG")
    return add_device_args(parser, kernel=False)


def build(args):
    from ..data import create_dataset
    from ..train import CRWTrainConfig

    cfg = CRWTrainConfig(
        model=args.model,
        patch_size=normalize_pair(args.patch_size),
        seq_length=args.seq_length,
        overlap=normalize_pair(args.overlap),
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        tau=args.tau,
        pos_embed=args.pos_embed,
        seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        remat=args.remat,
    )
    dataset = create_dataset(
        id=args.dataset,
        length=cfg.seq_length,
        dim=cfg.patch_size,
        overlap=cfg.overlap,
        full=args.dataset_full,
    )
    return cfg, dataset


def main(args):
    from ..train import CheckpointManager, CRWTrainer, save_encoder_torch
    from ..utils.plotting import plot_loss_curve
    from ..utils.profiling import profile_trace

    print(args)
    cfg, dataset = build(args)
    trainer = CRWTrainer(cfg, device=args.device)
    trainer.init_state(dataset[0].shape)
    print(f"Number of trainable parameters: {trainer.n_params}")

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            trainer.load_state_dict(mgr.restore())
            print(f"Resumed from step {mgr.latest_step()}")

    with profile_trace(args.profile_dir):
        history = trainer.fit(dataset)

    ensure_dirs(args.output_folder)
    if not args.no_plots:
        plot_loss_curve(history, os.path.join(args.output_folder, "output", "_loss.png"))
    out_pt = os.path.join(args.output_folder, "models", args.output_name + ".pt")
    save_encoder_torch(trainer.model, out_pt)
    if mgr is not None:
        mgr.save(trainer.step, trainer.state_dict())
        mgr.close()
    print(f"Saved encoder to {out_pt}")
    print("Finished training.")
    return trainer


if __name__ == "__main__":
    main(get_args_parser().parse_args())
