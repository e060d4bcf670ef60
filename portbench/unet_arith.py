"""The UNet's arithmetic: operations of one training step of the UNet
baseline (reference/unet.py), computed from shapes, as arith.py counts the
encoder's: multiply-adds counted twice, as torch.utils.flop_counter counts
convolutions; pooling, upsampling, BatchNorm, the loss and Adam are not
counted.
"""

from __future__ import annotations

from .reference.unet import DECODER, ENCODER


def unet_layers(H: int, W: int, n_channels: int = 1, n_classes: int = 5):
    """[(name, c_in, c_out, k, out_h, out_w)] of the bilinear UNet's
    convolutions on an H x W input, the stem first."""
    layers, c, h, w = [], n_channels, H, W
    sizes = []
    for name, width in ENCODER:
        if name != "inc":
            h, w = h // 2, w // 2
        layers += [(f"{name}.0", c, width, 3, h, w), (f"{name}.3", width, width, 3, h, w)]
        sizes.append((h, w))
        c = width
    sizes.pop()
    for name, c_in, c_out in DECODER:
        h, w = sizes.pop()  # the skip's size, which the upsampled map is padded to
        layers += [(f"{name}.0", c_in, c_in // 2, 3, h, w),
                   (f"{name}.3", c_in // 2, c_out, 3, h, w)]
    layers.append(("outc", c_out, n_classes, 1, H, W))
    return layers


def forward_flops(H: int, W: int, n_channels: int = 1, n_classes: int = 5) -> int:
    """Operations of one strip's forward."""
    return sum(2 * ci * co * k * k * oh * ow
               for _, ci, co, k, oh, ow in unet_layers(H, W, n_channels, n_classes))


def train_step_flops(B: int, H: int, W: int, n_channels: int = 1, n_classes: int = 5) -> int:
    """Operations of one step on B strips: the forward, and the weight and
    input gradients of every convolution but the stem's input gradient (the
    strips need none)."""
    _, ci, co, k, oh, ow = unet_layers(H, W, n_channels, n_classes)[0]
    stem = 2 * ci * co * k * k * oh * ow
    return B * (3 * forward_flops(H, W, n_channels, n_classes) - stem)
