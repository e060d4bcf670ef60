from .correction import correction_pixel_offset, splice_correction
from .integrate import integrate_bidirectional, integrate_flat_mcords3, reverse_unfold_flip
from .propagate import (
    PropagateResult,
    PropagationPipeline,
    encode_sequence,
    seed_onehot_from_segmentation,
)

__all__ = [
    "PropagateResult",
    "PropagationPipeline",
    "correction_pixel_offset",
    "encode_sequence",
    "integrate_bidirectional",
    "integrate_flat_mcords3",
    "reverse_unfold_flip",
    "seed_onehot_from_segmentation",
    "splice_correction",
]
