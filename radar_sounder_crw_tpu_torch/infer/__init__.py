from .propagate import (
    PropagateResult,
    PropagationPipeline,
    encode_sequence,
    seed_onehot_from_segmentation,
)

__all__ = [
    "PropagateResult",
    "PropagationPipeline",
    "encode_sequence",
    "seed_onehot_from_segmentation",
]
