"""Deterministic synthetic radargrams + ground-truth segmentations.

The reference pipelines run on proprietary MCoRDS / SHARAD products that are
not redistributable. For tests, benchmarks, and any host without the real
data, this module generates layered radargrams with the same statistical
character the algorithms rely on: a dark free-space region, a speckled ice
column with internal layering, a bright undulating bedrock return, and
incoherent noise below — plus a mid-flight-line regime change so the
change-point/correction machinery has something to find.

Class conventions follow the reference colormaps (reference: src/utils.py:178-199):
  MCORDS1 (4 cls): 0 free space, 1 inland ice, 2 bedrock, 3 noise
  MCORDS3 (6 cls): 0 free space, 1 noise, 2 bedrock, 3 inland ice,
                   4 floating ice, 5 uncertain
  SHARAD  (5 cls): 0 free space, 1 noise, 2 bedrock, 3 inland ice, 4 other

A copy of radar_sounder_crw_tpu/data/synthetic.py: the same numpy RNG stream,
so the arrays are byte-identical (tests/test_torch_pipeline.py checks it).
"""

from __future__ import annotations

import numpy as np


def _smooth_curve(rng: np.random.Generator, W: int, mean: float, wobble: float,
                  smoothness: int = 200) -> np.ndarray:
    """A slowly-varying horizon curve of length W around `mean`."""
    steps = rng.standard_normal(W)
    walk = np.cumsum(steps)
    k = max(1, min(smoothness, W))  # convolve 'same' needs kernel <= signal
    kernel = np.ones(k) / k
    walk = np.convolve(walk, kernel, mode="same")
    walk = walk - walk.mean()
    denom = max(np.abs(walk).max(), 1e-6)
    return mean + wobble * walk / denom


def synthetic_radargram(
    H: int = 410,
    W: int = 4096,
    nclasses: int = 4,
    seed: int = 11,
    change_point: float | None = 0.6,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate (radargram float32 (H, W), segmentation int32 (H, W)).

    `change_point` (fraction of W) makes layer geometry/texture change
    character mid-line, which the PELT detector should pick up.

    nclasses selects the labeling convention (4=MCORDS1, 5=SHARAD,
    6+=MCORDS3 — the class counts of the real products); fewer than 4
    classes cannot be generated.
    """
    if nclasses < 4:
        raise ValueError(f"nclasses must be >= 4 (got {nclasses})")
    rng = np.random.default_rng(seed)
    rows = np.arange(H)[:, None]

    surface = _smooth_curve(rng, W, mean=0.18 * H, wobble=0.05 * H)
    bedrock = _smooth_curve(rng, W, mean=0.72 * H, wobble=0.10 * H)
    if change_point is not None:
        cp = int(change_point * W)
        # after the change point the bedrock dives and roughens
        extra = _smooth_curve(rng, W - cp, mean=0.12 * H, wobble=0.06 * H)
        bedrock[cp:] = bedrock[cp:] + extra
    bedrock = np.clip(bedrock, surface + 0.08 * H, 0.95 * H)
    bed_thick = 6.0 + 3.0 * rng.random(W)

    seg = np.zeros((H, W), dtype=np.int32)
    in_ice = (rows >= surface[None, :]) & (rows < bedrock[None, :])
    in_bed = (rows >= bedrock[None, :]) & (rows < (bedrock + bed_thick)[None, :])
    below = rows >= (bedrock + bed_thick)[None, :]

    if nclasses >= 6:  # MCORDS3 convention
        ICE, BED, NOISE = 3, 2, 1
        # a floating-ice shelf on the last quarter of the line
        shelf = np.zeros(W, dtype=bool)
        shelf[int(0.78 * W):] = True
        seg[in_ice] = ICE
        seg[in_ice & shelf[None, :]] = 4
    elif nclasses == 5:  # SHARAD convention
        ICE, BED, NOISE = 3, 2, 1
        seg[in_ice] = ICE
        band = in_ice & (rows < (surface + 14)[None, :])
        seg[band] = 4
    else:  # MCORDS1 convention
        ICE, BED, NOISE = 1, 2, 3
        seg[in_ice] = ICE
    seg[in_bed] = BED
    seg[below] = NOISE

    # -- intensities ---------------------------------------------------------
    rg = 0.05 * rng.standard_normal((H, W)).astype(np.float32)
    ice_mask = seg == ICE
    # internal layering: horizontal striations that follow the surface
    depth = rows - surface[None, :]
    layering = 0.25 * np.sin(2 * np.pi * depth / 23.0) + 0.15 * np.sin(
        2 * np.pi * depth / 7.0
    )
    speckle = 0.18 * rng.standard_normal((H, W))
    rg = np.where(ice_mask, 0.45 + layering + speckle, rg).astype(np.float32)
    if nclasses >= 5:
        alt = seg == 4
        rg = np.where(alt, 0.35 + 0.5 * layering + speckle, rg).astype(np.float32)
    bed_mask = seg == BED
    rg = np.where(bed_mask, 1.4 + 0.3 * rng.standard_normal((H, W)), rg).astype(
        np.float32
    )
    noise_mask = seg == NOISE
    rg = np.where(noise_mask, 0.25 * rng.standard_normal((H, W)), rg).astype(
        np.float32
    )
    if change_point is not None:
        cp = int(change_point * W)
        rg[:, cp:] += 0.12 * rng.standard_normal((H, W - cp)).astype(np.float32)
    return rg, seg
