"""ResNet backbone (NCHW): the torchvision-style BasicBlock net the encoders
embed, at stage sizes (1, 1, 1, 1) a "ResNet-10".

Follows radar_sounder_crw_tpu/models/resnet.py (`BasicBlock`, `ResNetCore`)
with the plain 7x7/stride-2 stem only; the JAX package's space-to-depth stem
and batch-minor layout are TPU layout work and compute the same function.
Submodule names are the reference state_dict names (`conv1`, `bn1`,
`layer2.0.downsample.0`, `fc`), so weights load with `strict=True`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; flax momentum 0.9


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual connection (expansion 1)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, use_projection: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = batch_norm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                batch_norm(planes),
            )
            if use_projection
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + identity)


class ResNetCore(nn.Module):
    """Stem + four BasicBlock stages + global average pool + linear head."""

    def __init__(
        self,
        stage_sizes: Sequence[int] = (1, 1, 1, 1),
        num_classes: int = 128,
        width: int = 64,
        in_channels: int = 3,
    ):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(width)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, planes = width, width
        for stage, nblocks in enumerate(stage_sizes):
            blocks = []
            for block in range(nblocks):
                first = stage > 0 and block == 0
                blocks.append(
                    BasicBlock(inplanes, planes, stride=2 if first else 1, use_projection=first)
                )
                inplanes = planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))
