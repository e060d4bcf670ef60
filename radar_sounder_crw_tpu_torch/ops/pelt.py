"""PELT change-point detection with an RBF kernel cost.

Host-side (NumPy) implementation of Killick et al. 2012's Pruned Exact
Linear Time segmentation with the kernel cost used by the reference's
`ruptures.Pelt(model='rbf')` (reference: src/utils.py:126-132,
scripts/test/heatmap.py:105-106). ruptures is not a baked dependency of this
environment, so the algorithm is implemented here directly:

  * Gram matrix G = exp(-gamma * ||x_i - x_j||^2), gamma = 1 / median of the
    pairwise (off-diagonal) squared distances — the median heuristic of
    ruptures' CostRbf — with the scaled distances clipped to [1e-2, 1e2]
    before exponentiation exactly as ruptures does (costs/costrbf.py's
    np.clip on the condensed pdist; the diagonal stays exp(0)=1).
  * Segment cost c(a, b) = (b - a) - (1/(b-a)) * sum_{i,j in [a,b)} G_ij
    (within-segment kernel homogeneity).
  * PELT dynamic program over candidate breakpoints on a `jump` grid with
    `min_size` spacing and cost-based pruning. The pruning is the textbook
    K=0 rule (drop s when F[s] + c(s,t) > F[t]); kernel costs satisfy the
    concatenation inequality c(a,c) >= c(a,b) + c(b,c), so pruning never
    discards an optimal predecessor — tests/test_analysis.py proves the
    JAX package's copy optimal against exhaustive enumeration, and
    tests/test_torch_pipeline.py holds this copy equal to it.

A numpy copy of radar_sounder_crw_tpu/ops/pelt.py (the port imports nothing
of the JAX package). It runs on the host on purpose: it consumes a tiny
(T-2,) signal mid-pipeline, after the device has computed the xent metric.
"""

from __future__ import annotations

import numpy as np

from ..utils.profiling import span


def rbf_gram(signal: np.ndarray) -> np.ndarray:
    x = np.asarray(signal, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    off = sq[np.triu_indices_from(sq, k=1)]
    med = np.median(off) if off.size else 0.0
    gamma = 1.0 / med if med > 0 else 1.0
    K = gamma * sq
    np.clip(K, 1e-2, 1e2, K)  # ruptures costs/costrbf.py clips the condensed
    np.fill_diagonal(K, 0.0)  # ... distances only; the diagonal stays exp(0)
    return np.exp(-K)


def rbf_segment_cost(signal: np.ndarray):
    """The RBF segment-cost function c(a, b) over half-open [a, b) used by
    pelt_rbf, with O(1) evaluation via Gram prefix sums. Exposed so the
    optimality tests can score partitions with the exact same cost."""
    G = rbf_gram(np.asarray(signal, dtype=np.float64))
    n = len(G)
    P = np.zeros((n + 1, n + 1))
    P[1:, 1:] = G.cumsum(0).cumsum(1)

    def cost(a: int, b: int) -> float:
        block = P[b, b] - P[a, b] - P[b, a] + P[a, a]
        return (b - a) - block / (b - a)

    return cost


def pelt_rbf(
    signal: np.ndarray,
    pen: float,
    min_size: int = 2,
    jump: int = 5,
) -> list[int]:
    """Breakpoint list: segment end indices, always ending with len(signal).

    Mirrors ruptures' Pelt(model='rbf', min_size=2, jump=5).predict(pen).
    """
    x = np.asarray(signal, dtype=np.float64)
    n = len(x)
    if n < 2 * min_size:
        return [n]
    cost = rbf_segment_cost(x)

    # admissible breakpoint grid (multiples of jump, spaced by min_size)
    ends = [k for k in range(0, n, jump) if k >= min_size] + [n]
    F = {0: -pen}
    partitions: dict[int, list[int]] = {0: []}
    admissible: list[int] = [0]
    for t in ends:
        best_s, best_val = None, np.inf
        vals = {}
        for s in admissible:
            if t - s < min_size:
                continue
            v = F[s] + cost(s, t) + pen
            vals[s] = v
            if v < best_val:
                best_val, best_s = v, s
        if best_s is None:
            continue
        F[t] = best_val
        partitions[t] = partitions[best_s] + [t]
        # PELT pruning: drop s that can never win again
        admissible = [s for s in admissible if vals.get(s, -np.inf) <= best_val + pen]
        admissible.append(t)
    return partitions.get(n, []) or [n]


def detect_change_point(xent_column_diffs: np.ndarray, pen: float = 5.0) -> int | None:
    """Change index from the xent difference signal, with the reference's
    post-processing: second-to-last breakpoint + 5, clipped at 0; None when
    detection finds no interior breakpoint or fails
    (reference: src/utils.py:126-132). Runs in the span `crw.pelt`."""
    with span("crw.pelt"):
        try:
            bkps = pelt_rbf(np.asarray(xent_column_diffs), pen=pen)
            if len(bkps) < 2:
                return None
            return max(0, int(bkps[-2]) + 5)
        except Exception:
            return None
