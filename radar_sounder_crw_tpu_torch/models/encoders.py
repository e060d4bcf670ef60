"""Patch encoders producing one 128-d embedding per radargram patch (NCHW).

  * CNNEncoder    (model id 0): 5 convs + GAP + FC
  * ResNetEncoder (model id 1): a 1x1 stem to 3 channels + ResNet-10

Inputs are (B, C, h, w) float patches with C=1, or C=2 when the
positional-embedding channel is prepended. Follows
radar_sounder_crw_tpu/models/encoders.py, quirks included:
  * CNN: padding=1 on the two 5x5 convs, max-pools with stride 1;
  * ResNet stem: a 1x1 conv WITH padding 1, which grows the map by 2 px per
    side (the border pixels equal the conv bias before `bn0`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.device import resolve_device
from .resnet import ResNetCore, batch_norm


class CNNEncoder(nn.Module):
    """5 convs (5,5,3,3,3) -> GAP -> FC(128)."""

    def __init__(self, pos_embed: bool = False, embed_dim: int = 128):
        super().__init__()
        in_ch = 2 if pos_embed else 1
        self.conv1 = nn.Conv2d(in_ch, 8, 5, padding=1)
        self.conv2 = nn.Conv2d(8, 32, 5, padding=1)
        self.conv3 = nn.Conv2d(32, 64, 3, padding=1)
        self.conv4 = nn.Conv2d(64, 128, 3, padding=1)
        self.conv5 = nn.Conv2d(128, 128, 3, padding=1)
        self.pool = nn.MaxPool2d(2, stride=1)
        self.relu = nn.ReLU(inplace=True)
        self.fc = nn.Linear(128, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pool(self.relu(self.conv1(x)))
        x = self.pool(self.relu(self.conv2(x)))
        x = self.relu(self.conv3(x))
        x = self.relu(self.conv4(x))
        x = self.relu(self.conv5(x))
        return self.fc(x.mean(dim=(2, 3)))


class ResNetEncoder(nn.Module):
    """1x1(+pad) stem to 3ch + BN + ReLU, then the ResNet-10 core to 128."""

    def __init__(self, pos_embed: bool = False, embed_dim: int = 128, stage_sizes=(1, 1, 1, 1)):
        super().__init__()
        in_ch = 2 if pos_embed else 1
        self.fc0 = nn.Conv2d(in_ch, 3, 1, padding=1)
        self.bn0 = batch_norm(3)
        self.relu = nn.ReLU(inplace=True)
        self.model = ResNetCore(stage_sizes=stage_sizes, num_classes=embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(self.relu(self.bn0(self.fc0(x))))


def _init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default initialization drawn from `generator`, plus
    kaiming-normal fan-out (ReLU gain) on the ResNet core's convolutions, as
    radar_sounder_crw_tpu/models/initializers.py does on the JAX side."""
    core = set(model.model.modules()) if isinstance(model, ResNetEncoder) else set()
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if m in core and isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(
                    m.weight, mode="fan_out", nonlinearity="relu", generator=generator
                )
            else:
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def create_model(model_id: int, pos_embed: bool, device=None, seed: int = 0) -> nn.Module:
    """Integer model registry (0 = CNN, 1 = ResNet), initialized from `seed`
    on the CPU, in eval mode on `device` (default cuda; raises when absent)."""
    device = resolve_device(device)
    if model_id == 0:
        model = CNNEncoder(pos_embed=pos_embed)
    elif model_id == 1:
        model = ResNetEncoder(pos_embed=pos_embed)
    else:
        raise ValueError(f"unknown model id {model_id} (0=CNN, 1=ResNet)")
    _init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
