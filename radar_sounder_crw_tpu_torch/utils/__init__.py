from .device import parity_mode, resolve_device
from .ndiag import ndiag_matrix
from .plotting import dataset_cmap, plot_loss_curve, plot_segmentation, plot_xent_heatmap
from .pos_embed import maybe_pos_embed, pos_embed
from .profiling import profile_trace, span
from .resize import resize_bilinear_align_corners, resize_nearest

__all__ = [
    "dataset_cmap",
    "maybe_pos_embed",
    "ndiag_matrix",
    "parity_mode",
    "plot_loss_curve",
    "plot_segmentation",
    "plot_xent_heatmap",
    "pos_embed",
    "profile_trace",
    "resize_bilinear_align_corners",
    "resize_nearest",
    "resolve_device",
    "span",
]
