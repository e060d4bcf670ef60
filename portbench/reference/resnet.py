"""Plain float32 ResNet-10 patch encoder: the upstream ResNetEncoder (a 1x1
stem with padding 1 to 3 channels, BatchNorm, ReLU, then the torchvision
BasicBlock ResNet at stage sizes (1, 1, 1, 1), global average pool and a
linear head) written as functional PyTorch over a dict of tensors.

Parameter names are the upstream state-dict names (`fc0.weight`,
`model.layer2.0.downsample.0.weight`, ...). BatchNorm runs in eval mode on
the running statistics, or in train mode by flax's rule, which the
configuration states: float32 batch statistics, the one-pass variance
max(0, E[x^2] - E[x]^2), y = (x - mean) * (rsqrt(var + eps) * weight) + bias.
Nothing here imports the measured program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGES = (64, 128, 256, 512)


def _bn_names(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "bn_weight"), (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "bn_mean"), (f"{prefix}.running_var", (c,), "bn_var"),
            (f"{prefix}.num_batches_tracked", (), "count")]


def parameter_shapes(in_ch: int = 1, embed_dim: int = 128, width: int = 64):
    """[(name, shape, kind)] of every state-dict entry, in upstream order."""
    out = [("fc0.weight", (3, in_ch, 1, 1), "conv"), ("fc0.bias", (3,), "bias")]
    out += _bn_names("bn0", 3)
    out += [("model.conv1.weight", (width, 3, 7, 7), "conv")]
    out += _bn_names("model.bn1", width)
    inplanes = width
    for s, planes in enumerate(STAGES):
        p = f"model.layer{s + 1}.0"
        out += [(f"{p}.conv1.weight", (planes, inplanes, 3, 3), "conv")]
        out += _bn_names(f"{p}.bn1", planes)
        out += [(f"{p}.conv2.weight", (planes, planes, 3, 3), "conv")]
        out += _bn_names(f"{p}.bn2", planes)
        if s > 0:
            out += [(f"{p}.downsample.0.weight", (planes, inplanes, 1, 1), "conv")]
            out += _bn_names(f"{p}.downsample.1", planes)
        inplanes = planes
    out += [("model.fc.weight", (embed_dim, inplanes), "linear"),
            ("model.fc.bias", (embed_dim,), "bias")]
    return out


def batch_norm(x, p: dict, name: str, train: bool, stats: list | None = None):
    """BatchNorm of layer `name`; in train mode the batch's (mean, var) are
    appended to `stats` when given."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if not train:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        return (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS) \
            * w[:, None, None] + b[:, None, None]
    mean = x.mean(dim=(0, 2, 3))
    var = (x.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
    if stats is not None:
        stats.append((name, mean.detach(), var.detach()))
    mul = torch.rsqrt(var + BN_EPS) * w
    return (x - mean[:, None, None]) * mul[:, None, None] + b[:, None, None]


def encode(p: dict, x: torch.Tensor, train: bool = False, stats: list | None = None):
    """(B, 1, h, w) float32 patches -> (B, embed_dim) raw embeddings."""
    x = F.conv2d(x, p["fc0.weight"], p["fc0.bias"], padding=1)
    x = F.relu(batch_norm(x, p, "bn0", train, stats))
    x = F.conv2d(x, p["model.conv1.weight"], stride=2, padding=3)
    x = F.relu(batch_norm(x, p, "model.bn1", train, stats))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for s in range(len(STAGES)):
        q = f"model.layer{s + 1}.0"
        stride = 1 if s == 0 else 2
        if s > 0:
            identity = F.conv2d(x, p[f"{q}.downsample.0.weight"], stride=stride)
            identity = batch_norm(identity, p, f"{q}.downsample.1", train, stats)
        else:
            identity = x
        y = F.conv2d(x, p[f"{q}.conv1.weight"], stride=stride, padding=1)
        y = F.relu(batch_norm(y, p, f"{q}.bn1", train, stats))
        y = F.conv2d(y, p[f"{q}.conv2.weight"], padding=1)
        y = batch_norm(y, p, f"{q}.bn2", train, stats)
        x = F.relu(y + identity)
    x = x.mean(dim=(2, 3))
    return F.linear(x, p["model.fc.weight"], p["model.fc.bias"])


@torch.no_grad()
def embed(p: dict, patches: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """(..., h, w) patches -> (..., embed_dim) L2-normalised eval-mode
    embeddings, `block` patches a forward."""
    lead, (h, w) = patches.shape[:-2], patches.shape[-2:]
    flat = patches.reshape(-1, 1, h, w)
    out = torch.cat([encode(p, flat[i:i + block]) for i in range(0, flat.shape[0], block)])
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
    return out.reshape(*lead, -1)
