"""The CNN encoder's arithmetic (upstream model id 0, reference/cnn.py):
operations of one CRW training step, computed from shapes, under arith.py's
rule: multiply-adds counted twice, as torch.utils.flop_counter counts
convolutions and matrix products; pooling, ReLU, the average pool, biases
and Adam are not counted.
"""

from __future__ import annotations

from . import arith
from .reference.cnn import CONVS


def cnn_layers(h: int = 16, w: int = 16, in_ch: int = 1, embed_dim: int = 128):
    """[(name, c_in, c_out, k, out_h, out_w)] of the CNN's convolutions and
    its head (k = 1, 1 x 1 output) on an h x w patch, the stem first."""
    layers, c, H, W = [], in_ch, h, w
    for name, c_out, k, pad, pooled in CONVS:
        H, W = H + 2 * pad - k + 1, W + 2 * pad - k + 1
        layers.append((name, c, c_out, k, H, W))
        if pooled:  # 2 x 2, stride 1
            H, W = H - 1, W - 1
        c = c_out
    layers.append(("fc", c, embed_dim, 1, 1, 1))
    return layers


def encoder_flops(h: int = 16, w: int = 16, backward: bool = False) -> int:
    """Operations of one patch through the CNN; with backward, the forward
    plus the weight and input gradients of every layer but the stem's input
    gradient (the patches need none)."""
    per = [2 * ci * co * k * k * oh * ow for _, ci, co, k, oh, ow in cnn_layers(h, w)]
    fwd = sum(per)
    return 3 * fwd - per[0] if backward else fwd


def train_step_flops(B: int, T: int, N: int, h: int = 16, w: int = 16) -> int:
    """One step on B x T x N patches: the encoder forward and backward, and
    the CRW loss as arith.py counts it."""
    return B * T * N * encoder_flops(h, w, backward=True) + arith.crw_loss_flops(B, T, N)
