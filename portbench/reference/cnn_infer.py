"""Plain float32 inference embeddings of the CNN encoder (upstream model id
0): reference/cnn.py `encode` over the patches in blocks, each embedding
L2-normalised, as reference/resnet.py `embed` does for the ResNet. Full
float32 (reference/cnn.py turns TF32 off; the control turns it on around a
call). Nothing here imports the measured program.
"""

from __future__ import annotations

import torch

from .cnn import encode


@torch.no_grad()
def embed(p: dict, patches: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """(..., h, w) patches -> (..., embed_dim) L2-normalised embeddings,
    `block` patches a forward."""
    lead, (h, w) = patches.shape[:-2], patches.shape[-2:]
    flat = patches.reshape(-1, 1, h, w)
    out = torch.cat([encode(p, flat[i:i + block]) for i in range(0, flat.shape[0], block)])
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
    return out.reshape(*lead, -1)
