"""Horizontality cross-entropy metric + change-point signal.

Does node n of frame t+1 attend (under temperature-softmax affinity) back to
node n of frame t? Low CE = horizontal layering; a rise marks a change in the
radargram's character. Feeds the PELT change-point detector.

`quirk_channel_shift=True` reproduces the upstream code's literal product
between channel-shifted embeddings of the SAME frame; `row_softmax=True`
takes the softmax over the target axis instead of the source axis. Both are
described in radar_sounder_crw_tpu/ops/xent_metric.py.
"""

from __future__ import annotations

import torch


def horizontality_xent(
    emb: torch.Tensor,
    tau: float = 0.1,
    quirk_channel_shift: bool = False,
    row_softmax: bool = False,
) -> torch.Tensor:
    """emb: (..., T, N, C) L2-normalized. Returns xent (..., N, T-1); a
    leading batch axis runs every radargram at once."""
    T = emb.shape[-3]
    if quirk_channel_shift:
        e = emb[..., : T - 1, :, :]
        A = torch.einsum("...tnc,...tmc->...tnm", e[..., :-1], e[..., 1:]) / tau
    else:
        A = torch.einsum("...tnc,...tmc->...tnm", emb[..., :-1, :, :], emb[..., 1:, :, :]) / tau
    lse = torch.logsumexp(A, dim=-1 if row_softmax else -2)  # (..., T-1, N)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)  # (..., T-1, N)
    return (lse - diag).transpose(-1, -2)


def column_diffs(xent: torch.Tensor) -> torch.Tensor:
    """Σ_n |xent[..., :, i] - xent[..., :, i+1]|: (..., N, T-1) -> (..., T-2)."""
    return torch.abs(xent[..., :-1] - xent[..., 1:]).sum(dim=-2)
