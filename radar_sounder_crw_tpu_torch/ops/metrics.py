"""Evaluation metrics: confusion matrix, per-class precision/recall/F1
report, and mIoU.

Self-contained NumPy implementations with no sklearn dependency; the text
report follows sklearn's classification_report layout. A copy of
radar_sounder_crw_tpu/ops/metrics.py: the same validation errors and the
same report string, character for character.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int | None = None) -> np.ndarray:
    t = np.asarray(y_true).ravel().astype(np.int64)
    p = np.asarray(y_pred).ravel().astype(np.int64)
    if num_classes is None:
        num_classes = int(max(t.max(initial=-1), p.max(initial=-1))) + 1
    # validate like sklearn would: negative labels must not wrap to the last
    # row via fancy indexing, and out-of-range labels deserve a real message
    for name, arr in (("y_true", t), ("y_pred", p)):
        if arr.size and (arr.min() < 0 or arr.max() >= num_classes):
            bad = arr[(arr < 0) | (arr >= num_classes)]
            raise ValueError(
                f"{name} contains labels outside [0, {num_classes}): "
                f"{np.unique(bad)[:10].tolist()}"
            )
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def per_class_stats(cm: np.ndarray):
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)
    predicted = cm.sum(axis=0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1, support.astype(np.int64)


def miou(cm: np.ndarray) -> float:
    """Mean intersection-over-union over classes present in the GT."""
    tp = np.diag(cm).astype(np.float64)
    union = cm.sum(1) + cm.sum(0) - tp
    present = cm.sum(1) > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, tp / union, 0.0)
    return float(iou[present].mean()) if present.any() else 0.0


def classification_report(y_true, y_pred, num_classes: int | None = None) -> str:
    """sklearn-layout text report (precision/recall/f1/support per class,
    accuracy, macro and weighted averages)."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    precision, recall, f1, support = per_class_stats(cm)
    total = support.sum()
    accuracy = np.diag(cm).sum() / total if total else 0.0

    width = max(len(str(len(support) - 1)), len("weighted avg"))
    lines = [f"{'':>{width}}  precision    recall  f1-score   support", ""]
    for c in range(len(support)):
        lines.append(
            f"{c:>{width}}  {precision[c]:>9.2f} {recall[c]:>9.2f} "
            f"{f1[c]:>9.2f} {support[c]:>9d}"
        )
    lines.append("")
    lines.append(f"{'accuracy':>{width}}  {'':>9} {'':>9} {accuracy:>9.2f} {total:>9d}")
    w = support / total if total else np.zeros_like(support, dtype=float)
    lines.append(
        f"{'macro avg':>{width}}  {precision.mean():>9.2f} {recall.mean():>9.2f} "
        f"{f1.mean():>9.2f} {total:>9d}"
    )
    lines.append(
        f"{'weighted avg':>{width}}  {(precision * w).sum():>9.2f} "
        f"{(recall * w).sum():>9.2f} {(f1 * w).sum():>9.2f} {total:>9d}"
    )
    return "\n".join(lines)
