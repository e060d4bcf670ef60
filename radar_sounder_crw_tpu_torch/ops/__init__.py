from .labelprop import (
    NEG_INVALID,
    NEG_MASKED,
    LabelPropConfig,
    propagate_labels,
    propagate_labels_batched,
    radius_mask,
)
from .metrics import classification_report, confusion_matrix, miou, per_class_stats
from .pelt import detect_change_point, pelt_rbf, rbf_gram, rbf_segment_cost
from .xent_metric import column_diffs, horizontality_xent

__all__ = [
    "NEG_INVALID",
    "NEG_MASKED",
    "LabelPropConfig",
    "classification_report",
    "column_diffs",
    "confusion_matrix",
    "detect_change_point",
    "horizontality_xent",
    "miou",
    "pelt_rbf",
    "per_class_stats",
    "propagate_labels",
    "propagate_labels_batched",
    "radius_mask",
    "rbf_gram",
    "rbf_segment_cost",
]
