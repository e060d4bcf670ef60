"""Supervised UNet segmentation baseline (NCHW).

Follows radar_sounder_crw_tpu/models/unet.py (`DoubleConv`, `UNet`), the
milesial-style net of the reference: DoubleConv units (3x3 conv without
bias, BatchNorm, ReLU, twice), a 3-level encoder/decoder, upsampling
bilinear with align_corners=True (or a 2x2 transposed conv with
bilinear=False), skips padded (d//2, d - d//2) and concatenated as
[skip, upsampled], and a 1x1 head `outc` run in float32. Submodule names are
the reference's (`inc.double_conv.N`, `downK.maxpool_conv.1.double_conv.N`,
`upK.conv.double_conv.N`, `upK.up`, `outc.conv`), so its state_dicts, and
JAX variables through `state_dict_from_jax`, load with `strict=True`.
BatchNorm is the port's flax-rule one (models/resnet.py). A compute dtype
of bfloat16 runs everything but the head under `torch.autocast`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.resize import resize_bilinear_align_corners
from .encoders import _init_weights
from .resnet import BatchNorm, f32_head


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1, bias=False),
            BatchNorm(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = True):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(in_channels, out_channels, in_channels // 2)
        else:
            self.up = nn.ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
            self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """The upsample, pad and concat run in the span `crw.unet.up`; the
        DoubleConv after them does not."""
        with span("crw.unet.up"):
            if self.bilinear:
                x = resize_bilinear_align_corners(x, (x.shape[2] * 2, x.shape[3] * 2))
            else:
                x = self.up(x)
            dh = skip.shape[2] - x.shape[2]
            dw = skip.shape[3] - x.shape[3]
            x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            x = torch.cat([skip, x], dim=1)
        return self.conv(x)


class OutConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNet(nn.Module):
    def __init__(self, n_channels: int = 1, n_classes: int = 5, bilinear: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype} is not float32 or bfloat16")
        self.compute_dtype = dtype
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512 // factor)
        self.up1 = Up(512, 256 // factor, bilinear)
        self.up2 = Up(256, 128 // factor, bilinear)
        self.up3 = Up(128, 64, bilinear)
        self.outc = OutConv(64, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_channels, H, W) -> float32 logits (B, n_classes, H, W)."""
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            x1 = self.inc(x)
            x2 = self.down1(x1)
            x3 = self.down2(x2)
            x4 = self.down3(x3)
            y = self.up1(x4, x3)
            y = self.up2(y, x2)
            y = self.up3(y, x1)
        return f32_head(self.outc, y)


def create_unet(n_channels: int = 1, n_classes: int = 5, bilinear: bool = True,
                dtype=torch.float32, device=None, seed: int = 0) -> UNet:
    """A UNet with torch's default initialization drawn from `seed` on the
    CPU, in eval mode on `device` (default cuda; raises when absent)."""
    device = resolve_device(device)
    model = UNet(n_channels, n_classes, bilinear, dtype)
    _init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)
