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
    the nearest-upsampled corrected patch map (span `crw.assemble.splice`)."""
    with span("crw.assemble.splice"):
        out = np.asarray(prediction_px).copy()
        H = out.shape[0]
        up = np.asarray(resize_nearest(corrected_patchmap.astype(np.int32), (H, pixel_offset)))
        out[:, -pixel_offset:] = up
        return out
