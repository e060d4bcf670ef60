"""UNet weights made from the seed on the device, as a state dict under the
upstream parameter names (reference/unet.py `parameter_shapes`), loaded
into the program's UNet with strict=True.

As portbench/weights.py draws the encoder's: two draws of the whole size
(normal, uniform), cut into the entries: convolutions kaiming-normal
(fan-out, ReLU gain), the 1x1 head normal with std 1/sqrt(fan-in), its
bias and the BatchNorm shifts small normals, BatchNorm scales 1 + 0.1 n,
running means 0.1 n and running variances in [0.5, 1.5), so that eval-mode
BatchNorm is neither the identity nor degenerate.
"""

from __future__ import annotations

import math

import torch

from .reference.unet import parameter_shapes


@torch.no_grad()
def state_dict(seed: int, device, n_channels: int = 1, n_classes: int = 5) -> dict:
    shapes = parameter_shapes(n_channels, n_classes)
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
        elif kind == "head":
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
