"""Encoder weights made from the seed on the device, as a state dict under
the upstream parameter names (reference/resnet.py `parameter_shapes`).

Two draws of the whole size (normal, uniform), cut into the entries:
convolutions kaiming-normal (fan-out, ReLU gain), the head normal with
std 1/sqrt(fan-in), biases and BatchNorm shifts small normals, BatchNorm
scales 1 + 0.1 n, running means 0.1 n and running variances in [0.5, 1.5),
so that eval-mode BatchNorm is neither the identity nor degenerate.
"""

from __future__ import annotations

import math

import torch

from .reference import resnet
from .reference.resnet import parameter_shapes


@torch.no_grad()
def state_dict(seed: int, device, in_ch: int = 1, embed_dim: int = 128) -> dict:
    shapes = parameter_shapes(in_ch, embed_dim)
    total = sum(math.prod(s) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "conv":
            out[name] = z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif kind == "linear":
            out[name] = z / math.sqrt(shape[1])
        elif kind in ("bias", "bn_bias"):
            out[name] = 0.1 * z
        elif kind == "bn_weight":
            out[name] = 1.0 + 0.1 * z
        elif kind == "bn_mean":
            out[name] = 0.1 * z
        elif kind == "bn_var":
            out[name] = 0.5 + u
        else:  # the BatchNorm step count
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return {k: v.contiguous() for k, v in out.items()}


@torch.no_grad()
def calibrate(sd: dict, rg: torch.Tensor, patch, overlap, seed: int, n: int = 4096) -> dict:
    """`sd` with every BatchNorm's running statistics set to the batch
    statistics of n patches of radargram rg drawn from the seed, as a
    trained encoder's are: with random weights and arbitrary running
    statistics every patch embeds to nearly the same direction (mean
    cosine 0.97-0.9998 over 12 seeds), and propagation then decides between
    near-equal affinities."""
    (h, w), (oh, ow) = patch, overlap
    H, W = rg.shape
    g = torch.Generator(device=rg.device).manual_seed(seed)
    nr, nc = (H - h) // (h - oh) + 1, (W - w) // (w - ow) + 1
    r0 = torch.randint(nr, (n,), generator=g, device=rg.device) * (h - oh)
    c0 = torch.randint(nc, (n,), generator=g, device=rg.device) * (w - ow)
    rows = r0[:, None, None] + torch.arange(h, device=rg.device)[None, :, None]
    cols = c0[:, None, None] + torch.arange(w, device=rg.device)[None, None, :]
    x = rg[rows, cols][:, None]
    stats: list = []
    resnet.encode(sd, x, train=True, stats=stats)
    out = dict(sd)
    for name, mean, var in stats:
        out[f"{name}.running_mean"], out[f"{name}.running_var"] = mean.clone(), var.clone()
    return out
