"""CNN encoder weights (upstream model id 0) made from the seed on the
device, as a state dict under the upstream parameter names
(reference/cnn.py `parameter_shapes`), loaded into the program's CNN with
strict=True.

As portbench/weights.py draws the ResNet's: one normal draw of the whole
size, cut into the entries: convolutions kaiming-normal (fan-out, ReLU
gain), the head normal with std 1/sqrt(fan-in), biases small normals
(0.1 n).
"""

from __future__ import annotations

import math

import torch

from .reference.cnn import parameter_shapes


@torch.no_grad()
def state_dict(seed: int, device, in_ch: int = 1, embed_dim: int = 128) -> dict:
    shapes = parameter_shapes(in_ch, embed_dim)
    total = sum(math.prod(s) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        z = normal[at:at + n].view(shape)
        at += n
        if kind == "conv":
            out[name] = z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif kind == "linear":
            out[name] = z / math.sqrt(shape[1])
        else:  # a bias
            out[name] = 0.1 * z
    return {k: v.contiguous() for k, v in out.items()}
