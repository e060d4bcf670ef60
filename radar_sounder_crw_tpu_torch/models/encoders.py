"""Patch encoders producing one 128-d embedding per radargram patch (NCHW).

  * CNNEncoder    (model id 0): 5 convs + GAP + FC
  * ResNetEncoder (model id 1): a 1x1 stem to 3 channels + ResNet-10

Inputs are (B, C, h, w) float patches with C=1, or C=2 when the
positional-embedding channel is prepended. Follows
radar_sounder_crw_tpu/models/encoders.py, quirks included:
  * CNN: padding=1 on the two 5x5 convs, max-pools with stride 1;
  * ResNet stem: a 1x1 conv WITH padding 1, which grows the map by 2 px per
    side (the border pixels equal the conv bias before `bn0`).

A compute dtype of bfloat16 works as flax's `dtype` does: the parameters
stay float32, the convolutions and BatchNorm run under `torch.autocast`,
and the head `fc` runs in float32, so the embeddings come out float32.

The ResNet's eval forward at float32 runs each convolution with its
BatchNorm folded in (models/resnet.py `fold_conv_bn`) and no BatchNorm;
`bn_fold` counts the forwards that took the fold ("folded"), those that
did not ("plain", the CNN's too) and the folds built ("builds"); `patches`
counts the patches each kind of encoder took in, over every forward
(eval or train, folded or not): a host-side add of the batch size. Training
at float32 with the two-pass BatchNorm, the ResNet's stem (`fc0`, `bn0`)
runs in float64 (`ResNetEncoder._stem`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .resnet import BatchNorm, ResNetCore, conv_bn, f32_head, fold_conv_bn, make_norm

bn_fold = {"folded": 0, "plain": 0, "builds": 0}
patches = {"cnn": 0, "resnet": 0}


class _Encoder(nn.Module):
    """Runs `body` under autocast at the compute dtype, then the float32
    head."""

    compute_dtype = torch.float32

    def _autocast(self, x: torch.Tensor):
        # no cast cache: a CUDA graph of train steps may capture the forward,
        # and each weight is cast once a forward either way
        return torch.autocast(x.device.type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != torch.float32, cache_enabled=False)


class CNNEncoder(_Encoder):
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
        bn_fold["plain"] += 1
        patches["cnn"] += x.shape[0]
        with self._autocast(x):
            x = self.pool(self.relu(self.conv1(x)))
            x = self.pool(self.relu(self.conv2(x)))
            x = self.relu(self.conv3(x))
            x = self.relu(self.conv4(x))
            x = self.relu(self.conv5(x))
            feat = x.mean(dim=(2, 3))
        return f32_head(self.fc, feat)


class ResNetEncoder(_Encoder):
    """1x1(+pad) stem to 3ch + BN + ReLU, then the ResNet-10 core to 128."""

    def __init__(self, pos_embed: bool = False, embed_dim: int = 128, stage_sizes=(1, 1, 1, 1),
                 fused_bn=None):
        super().__init__()
        in_ch = 2 if pos_embed else 1
        self.fc0 = nn.Conv2d(in_ch, 3, 1, padding=1)
        self.bn0 = make_norm(fused_bn, 3)
        self.relu = nn.ReLU(inplace=True)
        self.model = ResNetCore(stage_sizes=stage_sizes, num_classes=embed_dim, fused_bn=fused_bn)
        self._fold = None  # (key, conv -> folded weight and bias, and the
        # small-map GEMMs' operands by (conv, H, W)); not state

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fold = self._eval_fold()
        bn_fold["plain" if fold is None else "folded"] += 1
        patches["resnet"] += x.shape[0]
        with self._autocast(x):
            feat = self.model.features(self.relu(self._stem(x, fold)), fold)
        return f32_head(self.model.fc, feat)

    def _stem(self, x: torch.Tensor, fold) -> torch.Tensor:
        """bn0(fc0(x)) (`conv_bn`). Training at float32 with the two-pass
        BatchNorm (`make_norm('twopass')`, the rule chosen for its exact
        statistics), both run in float64 and round once, at the end: bn0's
        batch statistics make the stem invariant to fc0's scale, so fc0's
        true weight gradient is eps-sized and all cancellation, and float32
        leaves it 1.7e-3 to 5.8e-3 from a float64 encoder's, with the thread
        count (JAX's float32 encoder 1.5e-3); float64 leaves ~1e-5. The
        one-pass rule (the default), the fused and lean BatchNorms and
        bfloat16 keep the float32 stem."""
        fc0, bn0 = self.fc0, self.bn0
        if not (self.training and bn0.training and type(bn0) is BatchNorm and bn0.twopass
                and self.compute_dtype == torch.float32):
            return conv_bn(fc0, bn0, x, fold)
        z = F.conv2d(x.double(), fc0.weight.double(), fc0.bias.double(), fc0.stride, fc0.padding)
        return bn0(z).float()

    def train(self, mode: bool = True):
        if mode:  # train steps replayed from a CUDA graph change weights unseen by _version
            self._fold = None
        return super().train(mode)

    def _eval_fold(self):
        """Each convolution with its BatchNorm folded in, where the eval
        forward may take them: the encoder and every BatchNorm in eval mode
        with running statistics, float32 compute, and no gradient asked of
        the parameters (the folded tensors carry none); else None. Built again when a
        source tensor moved or changed in place (its data_ptr and _version)
        or an eps changed."""
        if self.training or self.compute_dtype != torch.float32:
            return None
        pairs = [(self.fc0, self.bn0), *self.model.conv_bn_pairs()]
        grad = torch.is_grad_enabled()
        key = []
        for conv, bn in pairs:
            if bn.training or bn.running_mean is None or bn.running_var is None:
                return None
            key.append(bn.eps)
            for t in (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var):
                if t is None:
                    continue
                if grad and t.requires_grad:
                    return None
                key.append((t.data_ptr(), t._version))
        if self._fold is None or self._fold[0] != key:
            self._fold = key, {conv: fold_conv_bn(conv, bn) for conv, bn in pairs}
            bn_fold["builds"] += 1
        return self._fold[1]


def _init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default initialization drawn from `generator`, plus
    kaiming-normal fan-out (ReLU gain) on the ResNet core's convolutions, as
    radar_sounder_crw_tpu/models/initializers.py does on the JAX side."""
    core = set(model.model.modules()) if isinstance(model, ResNetEncoder) else set()
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if m in core and isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(
                    m.weight, mode="fan_out", nonlinearity="relu", generator=generator
                )
            else:
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def create_model(model_id: int, pos_embed: bool, device=None, seed: int = 0,
                 dtype=torch.float32, fused_bn=None) -> nn.Module:
    """Integer model registry (0 = CNN, 1 = ResNet), initialized from `seed`
    on the CPU, in eval mode on `device` (default cuda; raises when absent).
    `dtype` is the compute dtype (float32 or bfloat16); `fused_bn` picks
    the ResNet's BatchNorm as the JAX package's `make_norm` does (None,
    'twopass', True/'fused', 'lean'; models/resnet.py `make_norm`). The CNN
    has no BatchNorm and takes `fused_bn` unread, as the JAX trainer passes
    it to the ResNet alone."""
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} is not float32 or bfloat16")
    if model_id == 0:
        model = CNNEncoder(pos_embed=pos_embed)
    elif model_id == 1:
        model = ResNetEncoder(pos_embed=pos_embed, fused_bn=fused_bn)
    else:
        raise ValueError(f"unknown model id {model_id} (0=CNN, 1=ResNet)")
    model.compute_dtype = dtype
    _init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(device)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
