"""Plain float32 CNN patch encoder (upstream model id 0) and its CRW training
step: the upstream CNN (src/encoder.py) written as functional PyTorch over a
dict of tensors, with the CRW loss and Adam of reference/crw.py.

Parameter names are the upstream state-dict names (`conv1.weight` ...
`conv5.bias`, `fc.weight`, `fc.bias`). The network: a 5x5 convolution 1 -> 8
and a 5x5 convolution 8 -> 32, each followed by a ReLU and a 2x2 max-pool;
then 3x3 convolutions 32 -> 64 -> 128 -> 128, each followed by a ReLU; a
global average pool and a linear head to 128. Every convolution has a bias.
It keeps the published code's quirks:
  * the 5x5 convolutions have padding 1 (not 2), so each shrinks the map by
    2 px a side: 16 x 16 -> 14 x 14, 13 x 13 -> 11 x 11;
  * the max-pools have stride 1 (not 2): they overlap and shrink the map by
    one pixel, 14 -> 13 and 11 -> 10, so the 3x3 convolutions run at
    10 x 10.
There is no BatchNorm, so train and eval forwards are one. Nothing here
imports the measured program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import crw

# full float32 products and convolutions; the control (portbench/control.py)
# turns TF32 on around a call
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (name, c_out, kernel, padding, pooled after) of each convolution; the
# first's input channels are the patches' (2 with the positional channel)
CONVS = (("conv1", 8, 5, 1, True), ("conv2", 32, 5, 1, True), ("conv3", 64, 3, 1, False),
         ("conv4", 128, 3, 1, False), ("conv5", 128, 3, 1, False))


def parameter_shapes(in_ch: int = 1, embed_dim: int = 128):
    """[(name, shape, kind)] of every state-dict entry, in upstream order."""
    out, c = [], in_ch
    for name, c_out, k, _, _ in CONVS:
        out += [(f"{name}.weight", (c_out, c, k, k), "conv"), (f"{name}.bias", (c_out,), "bias")]
        c = c_out
    out += [("fc.weight", (embed_dim, c), "linear"), ("fc.bias", (embed_dim,), "bias")]
    return out


def encode(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, in_ch, h, w) float32 patches -> (B, embed_dim) raw embeddings."""
    for name, _, _, pad, pooled in CONVS:
        x = F.relu(F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], padding=pad))
        if pooled:
            x = F.max_pool2d(x, 2, stride=1)
    return F.linear(x.mean(dim=(2, 3)), p["fc.weight"], p["fc.bias"])


def train_step(params: dict, trainable: list, opt: crw.Adam, batch: torch.Tensor, tau: float):
    """One step on batch (B, T, N, h, w): (loss, {name: gradient}); updates
    `params` in place with Adam."""
    B, T, N, h, w = batch.shape
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in trainable}
    p = {**params, **leaves}
    emb = encode(p, batch.reshape(B * T * N, 1, h, w)).reshape(B, T, N, -1)
    loss = crw.crw_loss(emb, tau)
    grads = dict(zip(trainable, torch.autograd.grad(loss, [leaves[k] for k in trainable])))
    opt.step(params, grads)
    return float(loss.detach()), grads
