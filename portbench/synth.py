"""Synthetic radargrams and their ground truth, made on the device from a
seed.

The recipe of the program's data/synthetic.py (itself standing in for the
proprietary MCoRDS and SHARAD products), frozen here and written for a
`torch.Generator`, so that a 410 x 105120 line takes milliseconds on the
card instead of seconds of host NumPy: a dark free-space band, a speckled
ice column with internal layering that follows the surface, a bright
undulating bedrock return, incoherent noise below, and a change of
character at `change_point` of the width. Class conventions:
  MCORDS1 (4): 0 free space, 1 ice, 2 bedrock, 3 noise
  MCORDS3 (6): 0 free space, 1 noise, 2 bedrock, 3 ice, 4 floating ice
  SHARAD  (5): 0 free space, 1 noise, 2 bedrock, 3 ice, 4 other
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _smooth_curve(g: torch.Generator, W: int, mean: float, wobble: float, device,
                  smoothness: int = 200) -> torch.Tensor:
    walk = torch.randn(W, generator=g, device=device, dtype=torch.float64).cumsum(0)
    k = max(1, min(smoothness, W))
    full = F.conv1d(walk[None, None], torch.full((1, 1, k), 1.0 / k, dtype=torch.float64,
                                                 device=device), padding=k - 1)[0, 0]
    walk = full[(k - 1) // 2:(k - 1) // 2 + W]
    walk = walk - walk.mean()
    return mean + wobble * walk / walk.abs().max().clamp_min(1e-6)


@torch.no_grad()
def radargram(H: int, W: int, nclasses: int, seed: int, device,
              change_point: float | None = 0.6):
    """(radargram float32 (H, W), segmentation int64 (H, W)) on `device`."""
    if nclasses < 4:
        raise ValueError(f"nclasses must be >= 4 (got {nclasses})")
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.arange(H, device=device, dtype=torch.float64)[:, None]
    surface = _smooth_curve(g, W, 0.18 * H, 0.05 * H, device)
    bedrock = _smooth_curve(g, W, 0.72 * H, 0.10 * H, device)
    if change_point is not None:
        cp = int(change_point * W)
        bedrock[cp:] += _smooth_curve(g, W - cp, 0.12 * H, 0.06 * H, device)
    bedrock = torch.minimum(torch.maximum(bedrock, surface + 0.08 * H),
                            torch.full_like(bedrock, 0.95 * H))
    bed_thick = 6.0 + 3.0 * torch.rand(W, generator=g, device=device, dtype=torch.float64)

    seg = torch.zeros((H, W), dtype=torch.int64, device=device)
    in_ice = (rows >= surface) & (rows < bedrock)
    in_bed = (rows >= bedrock) & (rows < bedrock + bed_thick)
    below = rows >= bedrock + bed_thick
    if nclasses >= 6:
        ice, bed, noise = 3, 2, 1
        shelf = torch.zeros(W, dtype=torch.bool, device=device)
        shelf[int(0.78 * W):] = True
        seg[in_ice] = ice
        seg[in_ice & shelf] = 4
    elif nclasses == 5:
        ice, bed, noise = 3, 2, 1
        seg[in_ice] = ice
        seg[in_ice & (rows < surface + 14)] = 4
    else:
        ice, bed, noise = 1, 2, 3
        seg[in_ice] = ice
    seg[in_bed] = bed
    seg[below] = noise

    def randn():
        return torch.randn((H, W), generator=g, device=device)

    depth = (rows - surface).float()
    layering = 0.25 * torch.sin(2 * math.pi * depth / 23.0) + 0.15 * torch.sin(
        2 * math.pi * depth / 7.0)
    rg = 0.05 * randn()
    speckle = 0.18 * randn()
    rg = torch.where(seg == ice, 0.45 + layering + speckle, rg)
    if nclasses >= 5:
        rg = torch.where(seg == 4, 0.35 + 0.5 * layering + speckle, rg)
    rg = torch.where(seg == bed, 1.4 + 0.3 * randn(), rg)
    rg = torch.where(seg == noise, 0.25 * randn(), rg)
    if change_point is not None:
        cp = int(change_point * W)
        rg[:, cp:] += 0.12 * torch.randn((H, W - cp), generator=g, device=device)
    return rg.float().contiguous(), seg
