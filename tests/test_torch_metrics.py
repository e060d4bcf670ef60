"""The port's host analysis vs the JAX package's (CPU): metrics, the
k-diagonal matrix, the colormap tables and the plots.

Metrics and `ndiag_matrix` are numpy on both sides: equal values, the same
validation errors, and the classification report equal character for
character. The plots are compared by their tables and by the files they
write.
"""

import numpy as np
import pytest

from radar_sounder_crw_tpu.ops import metrics as jax_metrics
from radar_sounder_crw_tpu.utils import plotting as jax_plotting
from radar_sounder_crw_tpu.utils.ndiag import ndiag_matrix as jax_ndiag
from radar_sounder_crw_tpu_torch.ops import (
    classification_report,
    confusion_matrix,
    miou,
    per_class_stats,
)
from radar_sounder_crw_tpu_torch.utils import (
    dataset_cmap,
    ndiag_matrix,
    plot_loss_curve,
    plot_segmentation,
    plot_xent_heatmap,
)
from radar_sounder_crw_tpu_torch.utils.plotting import COLORS


@pytest.mark.parametrize(
    "n,ncls,num_classes,seed",
    [(500, 4, None, 0), (1200, 6, 6, 1), (300, 5, 8, 2), (50, 3, None, 3), (1, 2, 2, 4)],
)
def test_metrics_match_jax(n, ncls, num_classes, seed):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, ncls, n)
    # mostly right, some confusion, one class never predicted
    pred = np.where(rng.random(n) < 0.7, gt, rng.integers(0, ncls, n))
    pred[pred == ncls - 1] = 0
    cm = confusion_matrix(gt, pred, num_classes)
    want = jax_metrics.confusion_matrix(gt, pred, num_classes)
    assert cm.dtype == want.dtype and np.array_equal(cm, want)
    for got, exp in zip(per_class_stats(cm), jax_metrics.per_class_stats(want)):
        assert got.dtype == exp.dtype and np.array_equal(got, exp)
    assert miou(cm) == jax_metrics.miou(want)
    report = classification_report(gt, pred, num_classes)
    assert report == jax_metrics.classification_report(gt, pred, num_classes)
    assert "weighted avg" in report


def test_metrics_edge_cases_match_jax():
    empty = np.zeros((3, 3), np.int64)
    assert miou(empty) == jax_metrics.miou(empty) == 0.0
    assert classification_report([], [], 2) == jax_metrics.classification_report([], [], 2)
    for gt, pred in (([0, 1, 5], [0, 1, 1]), ([0, 1, 1], [0, -1, 1])):
        with pytest.raises(ValueError) as got:
            confusion_matrix(gt, pred, 3)
        with pytest.raises(ValueError) as want:
            jax_metrics.confusion_matrix(gt, pred, 3)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("size,n", [(1, 1), (5, 1), (6, 2), (7, 3), (9, 5)])
def test_ndiag_matrix_matches_jax(size, n):
    got, want = ndiag_matrix(size, n), jax_ndiag(size, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_colormap_tables_match_jax():
    assert COLORS == jax_plotting._COLORS
    for dataset in (0, 1, 2, 3, 7):
        got, want = dataset_cmap(dataset), jax_plotting.dataset_cmap(dataset)
        assert got.N == want.N and got.colors == want.colors


def test_each_plot_writes_its_file(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 6, (40, 60))
    files = {
        "seg.png": lambda p: plot_segmentation(img, save=p, dataset=1),
        "seg_gt.png": lambda p: plot_segmentation(img, save=p, seg=img[::-1], dataset=3,
                                                  aspect=2.0),
        "xent.png": lambda p: plot_xent_heatmap(rng.random((20, 9)), p, colorbar=True),
        "loss.png": lambda p: plot_loss_curve([3.0, 2.0, 1.5], p),
    }
    for name, plot in files.items():
        plot(str(tmp_path / name))
        assert (tmp_path / name).stat().st_size > 0, name
    plot_segmentation(img)  # no file asked for: draws and closes
