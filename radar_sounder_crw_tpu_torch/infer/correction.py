"""Change-point correction: re-seed and re-propagate the tail.

After PELT flags a change at frame `change_idx`, the pipeline re-propagates
a shorter window starting there, seeded by a segmentation column taken at the
change point, and splices the result over the tail of the original
prediction.

A copy of radar_sounder_crw_tpu/infer/correction.py.
"""

from __future__ import annotations

import numpy as np

from ..utils.profiling import span
from ..utils.resize import resize_nearest


def correction_pixel_offset(small_length: int, patch_w: int, overlap_w: int) -> int:
    """Tail width in pixels covered by the correction window."""
    return small_length * (patch_w - overlap_w)


def splice_correction(
    prediction_px: np.ndarray,
    corrected_patchmap: np.ndarray,
    pixel_offset: int,
) -> np.ndarray:
    """Overwrite the last `pixel_offset` pixel columns of prediction_px with
    the nearest-upsampled corrected patch map (span `crw.assemble.splice`).
    The patch map is resized in prediction_px's dtype, so an int8 map
    stays int8 throughout."""
    with span("crw.assemble.splice"):
        out = np.asarray(prediction_px).copy()
        H = out.shape[0]
        patch = corrected_patchmap.astype(out.dtype, copy=False)
        out[:, -pixel_offset:] = resize_nearest(patch, (H, pixel_offset))
        return out
