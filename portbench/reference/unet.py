"""Plain float32 UNet segmentation baseline and its training step: the
upstream UNet (src/unet.py, the milesial net built as UNet(n_channels=1,
n_classes=5)) with bilinear upsampling, as the configuration states, written
as functional PyTorch over a dict of tensors, and the job's loss and Adam
(scripts/test/test_unet.py).

Parameter names are the upstream state-dict names
(`inc.double_conv.0.weight`, `down1.maxpool_conv.1.double_conv.3.weight`,
`up1.conv.double_conv.1.running_mean`, `outc.conv.weight`, ...). A
DoubleConv is a 3x3 convolution without bias, BatchNorm and ReLU, twice;
the encoder takes 64, then 2x2 max pools to 128, 256 and 256 channels; each
decoder level upsamples by 2 (bilinear, corners aligned), pads the result
to its skip's size (d // 2 before, the rest after), concatenates
[skip, upsampled] and runs a DoubleConv whose middle width is half its
input's (512 -> 256 -> 128, 256 -> 128 -> 64, 128 -> 64 -> 64); a 1x1
convolution with bias gives the class logits.

BatchNorm in train mode follows flax's rule, which the configuration
states (reference/resnet.py `batch_norm`: the one-pass biased variance).
torch's `BatchNorm2d` in the published code normalises by the same biased
batch variance and differs only in the running variance it keeps
(unbiased), which nothing here compares. The loss keeps the job's quirk
by default: the cross-entropy is applied to the soft-maxed logits, so the
logits are soft-maxed twice. Nothing here imports the measured program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import crw, resnet

# full float32 products and convolutions; the control (portbench/control.py)
# turns TF32 on around a call
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ENCODER = (("inc", 64), ("down1", 128), ("down2", 256), ("down3", 256))
DECODER = (("up1", 512, 128), ("up2", 256, 64), ("up3", 128, 64))  # (name, in, out)


def _double_conv_names(prefix: str, c_in: int, c_mid: int, c_out: int):
    out = [(f"{prefix}.double_conv.0.weight", (c_mid, c_in, 3, 3), "conv")]
    out += resnet._bn_names(f"{prefix}.double_conv.1", c_mid)
    out += [(f"{prefix}.double_conv.3.weight", (c_out, c_mid, 3, 3), "conv")]
    out += resnet._bn_names(f"{prefix}.double_conv.4", c_out)
    return out


def _prefix(name: str) -> str:
    if name == "inc":
        return "inc"
    if name.startswith("down"):
        return f"{name}.maxpool_conv.1"
    return f"{name}.conv"


def parameter_shapes(n_channels: int = 1, n_classes: int = 5):
    """[(name, shape, kind)] of every state-dict entry, in upstream order."""
    out, c = [], n_channels
    for name, width in ENCODER:
        out += _double_conv_names(_prefix(name), c, width, width)
        c = width
    for name, c_in, c_out in DECODER:
        out += _double_conv_names(_prefix(name), c_in, c_in // 2, c_out)
    out += [("outc.conv.weight", (n_classes, 64, 1, 1), "head"),
            ("outc.conv.bias", (n_classes,), "bias")]
    return out


def _double_conv(x, p: dict, prefix: str, train: bool):
    for conv, bn in ((0, 1), (3, 4)):
        x = F.conv2d(x, p[f"{prefix}.double_conv.{conv}.weight"], padding=1)
        x = F.relu(resnet.batch_norm(x, p, f"{prefix}.double_conv.{bn}", train))
    return x


def _up(x, skip):
    x = F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                      align_corners=True)
    dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
    x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return torch.cat([skip, x], dim=1)


def forward(p: dict, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """(B, n_channels, H, W) float32 -> logits (B, n_classes, H, W); BatchNorm
    on the batch's statistics (train) or the running ones."""
    skips = []
    for name, _ in ENCODER:
        if name != "inc":
            x = F.max_pool2d(x, 2)
        x = _double_conv(x, p, _prefix(name), train)
        skips.append(x)
    x = skips.pop()
    for name, _, _ in DECODER:
        x = _double_conv(_up(x, skips.pop()), p, _prefix(name), train)
    return F.conv2d(x, p["outc.conv.weight"], p["outc.conv.bias"])


def loss(logits: torch.Tensor, onehot: torch.Tensor, quirk: bool = True) -> torch.Tensor:
    """logits (B, M, H, W), onehot (B, H, W, M) -> the mean over every pixel
    of the cross-entropy against the one-hot labels, taken of the soft-maxed
    logits (quirk) or of the logits."""
    z = logits.permute(0, 2, 3, 1)
    if quirk:
        z = torch.softmax(z, dim=-1)
    return -(onehot * torch.log_softmax(z, dim=-1)).sum(dim=-1).mean()


def train_step(params: dict, trainable: list, opt: crw.Adam, x: torch.Tensor,
               onehot: torch.Tensor, quirk: bool = True):
    """One step on the batch x (B, n_channels, H, W), onehot (B, H, W, M):
    (loss, {name: gradient}); updates `params` in place with Adam (train-mode
    BatchNorm; running statistics are not kept)."""
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in trainable}
    p = {**params, **leaves}
    value = loss(forward(p, x, train=True), onehot, quirk)
    grads = dict(zip(trainable, torch.autograd.grad(value, [leaves[k] for k in trainable])))
    opt.step(params, grads)
    return float(value.detach()), grads
