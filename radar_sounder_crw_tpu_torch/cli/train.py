"""CRW unsupervised training (the port of scripts/train.py): the same flags
and defaults, the same printed lines (parameter count, one line per epoch,
`Saved encoder to ...`, `Finished training.`), the encoder written as a
reference-layout `.pt`, and `--ckpt_dir`/`--resume` through torch
checkpoints. Besides the script's flags: `--device` (default cuda) and
`--no_plots` (skip `output/_loss.png`). `--steps_per_dispatch k` runs each
k full batches as one dispatch: one CUDA graph replay of k steps on the
card, k eager steps on the CPU (train/crw_trainer.py).

`--tune` runs the ASHA search (train/tune.py) over the reference's grid,
one trial per visible CUDA device unless `--tune_sequential`, with
per-rung checkpoints under `--tune_ckpt_dir` that a rerun resumes from.

Started by `torch.distributed.run`, training is data parallel over the
ranks (one a device; NCCL, or gloo with `--device cpu`); rank 0 alone
prints and writes the files.

    python -m radar_sounder_crw_tpu_torch.cli.train --dataset 3 --model 1 [--bf16] ...
    python -m radar_sounder_crw_tpu_torch.cli.train --tune [--tune_samples 4] ...
    python -m torch.distributed.run --nproc_per_node 2 -m radar_sounder_crw_tpu_torch.cli.train ...
"""

from __future__ import annotations

import argparse
import os

import torch

from ._common import add_device_args, ensure_dirs, normalize_pair, process_group


def get_args_parser():
    parser = argparse.ArgumentParser("CRW Train", add_help=True)
    parser.add_argument("--tune", action="store_true", help="run ASHA hyperparameter search")
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
    parser.add_argument("--steps_per_dispatch", default=1, type=int,
                        help="k optimizer steps a dispatch (one CUDA graph replay on the card)")
    parser.add_argument("--seed", default=11, type=int)
    parser.add_argument("--ckpt_dir", default=None, help="checkpoint dir (enables resume)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the run to this dir")
    parser.add_argument("--no_plots", action="store_true", help="skip the loss-curve PNG")
    parser.add_argument("--tune_samples", default=50, type=int)
    parser.add_argument("--tune_sequential", action="store_true",
                        help="disable the one-trial-per-device parallel sweep")
    parser.add_argument("--tune_ckpt_dir", default=None,
                        help="per-rung sweep checkpoints (resume after a kill)")
    parser.add_argument("--tune_dataset", default=0, type=int,
                        help="dataset id for --tune trials (reference hardcodes 0)")
    parser.add_argument("--tune_model", default=1, type=int)
    parser.add_argument("--tune_seq_length", default=8, type=int)
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
        steps_per_dispatch=args.steps_per_dispatch,
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
    """Train on `--device`, or data parallel over the process group when
    `torch.distributed.run` started this process."""
    with process_group(args.device) as lead:
        return _train(args, lead)


def _train(args, lead: bool):
    from ..parallel import default_mesh
    from ..train import CheckpointManager, CRWTrainer, save_encoder_torch
    from ..utils.plotting import plot_loss_curve
    from ..utils.profiling import profile_trace

    print(args)
    cfg, dataset = build(args)
    trainer = CRWTrainer(cfg, mesh=default_mesh(args.device))
    trainer.init_state(dataset[0].shape)
    print(f"Number of trainable parameters: {trainer.n_params}")

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            trainer.load_state_dict(mgr.restore())
            print(f"Resumed from step {mgr.latest_step()}")

    with profile_trace(args.profile_dir if lead else None):
        history = trainer.fit(dataset)

    if lead:
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


# the reference's Ray grid (scripts/train.py:108-128)
TUNE_SPACE = {
    "batch_size": [16, 8],
    "lr": [1e-2, 1e-3, 1e-4, 1e-5],
    "tau": [1e-1, 1e-2, 1e-3, 1e-4],
    "patch_size": [(32, 32)],
    "overlap": [(24, 0), (16, 0)],
    "pos_embed": [False, True],
}


def tune_main(args, space=None):
    """ASHA search over the reference's grid (`space` overrides it) with its
    schedule: max_t 3, grace period 1, reduction factor 2. Trials run one per
    visible CUDA device in parallel (the reference's one-GPU Ray trials)
    unless --tune_sequential, or on --device when that is the CPU; with
    --tune_ckpt_dir the sweep checkpoints every rung and resumes."""
    import threading

    from ..data import create_dataset
    from ..train import CRWTrainConfig, CRWTrainer, run_asha
    from ..utils.device import resolve_device

    space = space or TUNE_SPACE
    seq_length = args.tune_seq_length
    datasets: dict = {}
    ds_lock = threading.Lock()

    def make_trainer(config, mesh=None):
        key = (config["patch_size"], config["overlap"])
        with ds_lock:
            if key not in datasets:
                datasets[key] = create_dataset(
                    id=args.tune_dataset, length=seq_length, dim=config["patch_size"],
                    overlap=config["overlap"], full=True,
                )
        cfg = CRWTrainConfig(
            model=args.tune_model, patch_size=config["patch_size"], seq_length=seq_length,
            overlap=config["overlap"], batch_size=config["batch_size"],
            epochs=1, lr=config["lr"], tau=config["tau"],
            pos_embed=config["pos_embed"], seed=args.seed,
        )
        trainer = CRWTrainer(cfg, device=args.device, mesh=mesh)
        trainer.init_state(datasets[key][0].shape)
        trainer._tune_dataset = datasets[key]
        return trainer

    def train_epoch(trainer):
        return trainer.fit(trainer._tune_dataset, log=lambda s: None)[-1]

    devices = None
    if not args.tune_sequential:
        device = resolve_device(args.device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
    return run_asha(
        make_trainer, train_epoch, space,
        num_samples=args.tune_samples, max_t=3, grace_period=1, reduction_factor=2,
        seed=args.seed, devices=devices, checkpoint_dir=args.tune_ckpt_dir,
    )


if __name__ == "__main__":
    args = get_args_parser().parse_args()
    if args.tune:
        tune_main(args)
    else:
        main(args)
