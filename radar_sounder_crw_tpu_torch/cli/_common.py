"""Shared plumbing of the command-line entry points: flag parsing helpers,
output folders and the encoder loader (the role of scripts/_common.py)."""

from __future__ import annotations

import os

from ..models import create_model, load_torch_checkpoint
from ..ops.labelprop import KERNELS
from ..utils.device import parity_mode, resolve_device


def normalize_pair(v) -> tuple[int, int]:
    """(h, w)-style flags: `--patch_size 16 16`, `--patch_size 16` and tuple
    defaults all parse."""
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(x) for x in v)
    return (t[0], t[0]) if len(t) == 1 else (t[0], t[1])


def ensure_dirs(output_folder: str):
    for sub in ("", "models", "output"):
        os.makedirs(os.path.join(output_folder, sub), exist_ok=True)


def add_device_args(parser, kernel: bool = True):
    """--device, and --kernel for the entry points that propagate."""
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; raises without one, "
                        "so a CPU run passes --device cpu)")
    if kernel:
        parser.add_argument("--kernel", default="auto", choices=("auto", *KERNELS),
                            help="propagation route (see ops/labelprop.propagate_labels)")
    return parser


def load_encoder(model_id: int, pos_embed: bool, model_path: str | None,
                 allow_untrained: bool = False, device="cuda", seed: int = 11):
    """The encoder in eval mode on `device`, weights from the reference-layout
    `.pt` at model_path (models/checkpoint.py). With allow_untrained, a
    missing file falls back to the fresh init of `seed` (a local generator:
    two runs give the same weights). Float32 products run with TF32 off."""
    device = resolve_device(device)
    parity_mode()
    model = create_model(model_id, pos_embed, device=device, seed=seed)
    if model_path and os.path.exists(model_path):
        load_torch_checkpoint(model_path, model)
        print(f"Loaded encoder weights from {model_path}")
        return model
    if allow_untrained:
        print(
            f"[warn] model weights not found at {model_path!r}; proceeding "
            "with a fresh initialization (--allow_untrained)"
        )
        return model
    raise FileNotFoundError(
        f"encoder weights not found at {model_path!r} — run scripts/train.py "
        "first, or pass --allow_untrained for a smoke run"
    )
