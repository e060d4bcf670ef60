from .labelprop import (
    NEG_INVALID,
    NEG_MASKED,
    LabelPropConfig,
    propagate_labels,
    propagate_labels_batched,
    radius_mask,
)
from .pelt import detect_change_point, pelt_rbf, rbf_gram, rbf_segment_cost
from .xent_metric import column_diffs, horizontality_xent

__all__ = [
    "NEG_INVALID",
    "NEG_MASKED",
    "LabelPropConfig",
    "column_diffs",
    "detect_change_point",
    "horizontality_xent",
    "pelt_rbf",
    "propagate_labels",
    "propagate_labels_batched",
    "radius_mask",
    "rbf_gram",
    "rbf_segment_cost",
]
