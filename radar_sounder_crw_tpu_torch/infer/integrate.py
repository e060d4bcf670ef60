"""Bidirectional integration: merge forward and reverse propagation passes.

The reverse pass propagates from the LAST frame (`use_last`); its
prediction is flipped back and merged into the forward map with
dataset-specific class priority masks:

  * MCORDS1-style: reverse bedrock (2) overrides; then reverse noise (1)
    overrides where forward isn't bedrock.
  * MCORDS3-style: reverse bedrock (2) / inland ice (3) override only in
    columns with no floating ice (4) anywhere in the forward map.
  * the flat merges of the upstream test_all script, on flattened maps.

A copy of radar_sounder_crw_tpu/infer/integrate.py.
"""

from __future__ import annotations

import numpy as np

from ..utils.profiling import span


def reverse_unfold_flip(pred: np.ndarray, rg_len: int) -> np.ndarray:
    """Flip each rg_len-wide block of a concatenated prediction map back to
    forward orientation (span `crw.assemble.unflip`)."""
    with span("crw.assemble.unflip"):
        H, W = pred.shape
        nblocks = W // rg_len
        blocks = pred[:, : nblocks * rg_len].reshape(H, nblocks, rg_len)
        return blocks[:, :, ::-1].reshape(H, nblocks * rg_len)


def integrate_bidirectional(
    forward: np.ndarray,
    reverse: np.ndarray,
    style: str,
    bedrock: int = 2,
    noise: int = 1,
    inland_ice: int = 3,
    floating_ice: int = 4,
) -> np.ndarray:
    """Merge a reverse-pass map into the forward map. `reverse` must already
    be flipped back to forward orientation (span `crw.assemble.merge`)."""
    with span("crw.assemble.merge"):
        out = np.asarray(forward).copy()
        rev = np.asarray(reverse)
        if style == "mcords1":
            out[rev == bedrock] = bedrock
            mask2 = (rev == noise) & (forward != bedrock)
            out[mask2] = noise
        elif style == "mcords3":
            no_shelf = ~np.any(forward == floating_ice, axis=0, keepdims=True)
            no_shelf = np.broadcast_to(no_shelf, forward.shape)
            out[(rev == bedrock) & no_shelf] = bedrock
            out[(rev == inland_ice) & no_shelf] = inland_ice
        elif style == "bedrock_only":
            out[rev == bedrock] = bedrock
        else:
            raise ValueError(f"unknown integration style {style!r}")
        return out


def integrate_flat_mcords3(
    forward_flat: np.ndarray, reverse_map: np.ndarray, bedrock: int = 2,
    inland_ice_fwd_guard: int = 3, floating_ice: int = 4,
) -> np.ndarray:
    """The Miguel merge on flattened maps: reverse bedrock wins where forward
    isn't inland ice AND the reverse column holds no floating ice (span
    `crw.assemble.merge`)."""
    with span("crw.assemble.merge"):
        out = np.asarray(forward_flat).copy()
        rev_flat = reverse_map.ravel()
        mask = (rev_flat == bedrock) & (out != inland_ice_fwd_guard)
        col_clear = np.all(reverse_map != floating_ice, axis=0)
        mask &= np.broadcast_to(col_clear[None, :], reverse_map.shape).ravel()
        out[mask] = bedrock
        return out
