"""Row-normalized k-diagonal matrices; a copy of
radar_sounder_crw_tpu/utils/ndiag.py.

With n <= 2 this is the identity — the cross-entropy target of the
horizontality metric; wider bands allow banded transition masks.
"""

from __future__ import annotations

import numpy as np


def ndiag_matrix(size: int, n: int = 1) -> np.ndarray:
    m = np.zeros((size, size), dtype=np.float32)
    np.fill_diagonal(m, 1.0)
    for off in range(0, max(n - 1, 0)):
        np.fill_diagonal(m[:, off:], 1.0)
        np.fill_diagonal(m[off:, :], 1.0)
    return m / m.sum(axis=1, keepdims=True)
