"""Visualize one windowed patch grid, the demo of the data layer (the port
of scripts/show_grid.py).

    python -m radar_sounder_crw_tpu_torch.cli.show_grid --dataset 0 --output grid.png
"""

from __future__ import annotations

import argparse

from ..utils.device import resolve_device
from ._common import add_device_args, normalize_pair


def get_args_parser():
    p = argparse.ArgumentParser("Patch-grid demo")
    p.add_argument("--dataset", default=0, type=int)
    p.add_argument("--seq_length", default=4, type=int)
    p.add_argument("--patch_size", default=(48, 48), nargs="+", type=int)
    p.add_argument("--overlap", default=(0, 0), nargs="+", type=int)
    p.add_argument("--index", default=0, type=int)
    p.add_argument("--output", default=None)
    return add_device_args(p, kernel=False)


def main(args):
    from ..data import create_dataset
    from ..utils.plotting import pyplot

    resolve_device(args.device)  # a host-only demo, but every entry point refuses a missing GPU
    plt = pyplot()
    ds = create_dataset(
        id=args.dataset, length=args.seq_length,
        dim=normalize_pair(args.patch_size),
        overlap=normalize_pair(args.overlap), full=True,
    )
    images = ds[args.index]
    T, N, h, w = images.shape
    fig, axes = plt.subplots(N, T, figsize=(13, 13), squeeze=False)
    for t in range(T):
        for n in range(N):
            ax = axes[n, t]
            ax.imshow(-images[t, n], cmap="gray", vmin=-1, vmax=1.5)
            ax.axis("off")
    plt.tight_layout()
    out = args.output or "grid.png"
    plt.savefig(out)
    plt.close()
    print(f"Saved patch grid ({T}x{N} patches) to {out}")


if __name__ == "__main__":
    main(get_args_parser().parse_args())
