"""Vertical positional-embedding channel for NCHW patch inputs.

Prepends a channel holding the normalized fast-time (depth) coordinate
`arange(h)/h - 0.5`, constant along the trace axis. Channel order is
[pe, data], so two-channel conv weights carried over from the JAX package
line up.
"""

from __future__ import annotations

import torch


def pos_embed(x: torch.Tensor) -> torch.Tensor:
    """x: (B, 1, h, w) -> (B, 2, h, w) with the pe channel first."""
    B, _, h, w = x.shape
    pe = torch.arange(h, dtype=x.dtype, device=x.device) / h - 0.5
    pe = pe[None, None, :, None].expand(B, 1, h, w)
    return torch.cat([pe, x], dim=1)


def maybe_pos_embed(x: torch.Tensor, enabled: bool) -> torch.Tensor:
    return pos_embed(x) if enabled else x
