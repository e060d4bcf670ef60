"""Plotting: paper colormaps, prediction maps, xent heatmaps, loss curves.

The colormap tables and the figures are those of
radar_sounder_crw_tpu/utils/plotting.py. matplotlib (Agg backend, no
display) is imported inside each function, so importing this module needs
no matplotlib.
"""

from __future__ import annotations

import numpy as np

# one RGB(A) row per class label, by dataset id (unknown ids take 0's)
COLORS = {
    0: [(0, 0, 0), (0.33, 0.33, 0.33), (1, 0, 0), (1, 1, 1)],
    1: [
        (0, 0, 0, 1),  # black: free space
        (1, 1, 1, 1),  # white: noise
        (1, 0, 0, 1),  # red: bedrock
        (0.33, 0.33, 0.33, 1),  # dark gray: inland ice
        (0.66, 0.66, 0.66, 1),  # light gray: floating ice
        (1.0, 0.75, 0.0, 1),  # amber: 'uncertain' (label 5), its own color
    ],
    3: [
        (0, 0, 0, 1),
        (0.33, 0.33, 0.33, 1),
        (1, 0, 0, 1),
        (1, 1, 1, 1),
        (0.66, 0.66, 0.66, 1),
    ],
}


def pyplot():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def dataset_cmap(dataset: int):
    """The dataset's class colormap (a matplotlib ListedColormap)."""
    from matplotlib.colors import ListedColormap

    return ListedColormap(COLORS.get(dataset, COLORS[0]))


def plot_segmentation(img, save=None, seg=None, dataset: int = 0, aspect: float = 1.0):
    """Prediction map, optionally stacked over the ground truth. vmax tracks
    the colormap length, so every label gets its own color."""
    plt = pyplot()
    cmap = dataset_cmap(dataset)
    vmax = cmap.N - 1
    if seg is None:
        plt.imshow(np.asarray(img), interpolation="nearest", cmap=cmap, vmin=0, vmax=vmax)
        plt.gca().set_aspect(aspect)
        plt.tight_layout()
    else:
        plt.figure(figsize=(13, 13))
        fs = 12
        plt.subplot(211)
        plt.imshow(np.asarray(img), interpolation="nearest", cmap=cmap, vmin=0, vmax=vmax)
        plt.xlabel("Trace", fontsize=fs)
        plt.subplot(212)
        plt.imshow(np.asarray(seg), interpolation="nearest", cmap=cmap, vmin=0, vmax=vmax)
        plt.ylabel("Time [μs]", fontsize=fs)
        plt.xlabel("Trace", fontsize=fs)
        plt.tight_layout()
    if save is not None:
        plt.savefig(save)
    plt.close()


def plot_xent_heatmap(xent, save, aspect_scale: float = 0.77, colorbar: bool = False):
    """Horizontality-metric heatmap, (N, T-1) in gray."""
    plt = pyplot()
    x = np.asarray(xent)
    plt.imshow(x, interpolation="nearest", cmap="gray")
    plt.gca().set_aspect(x.shape[1] / x.shape[0] * aspect_scale)
    if colorbar:
        plt.colorbar()
    plt.savefig(save)
    plt.close()


def plot_loss_curve(losses, save):
    """Training loss curve."""
    plt = pyplot()
    plt.plot(list(losses))
    plt.savefig(save)
    plt.close()
