"""ResNet backbone (NCHW): the torchvision-style BasicBlock net the encoders
embed, at stage sizes (1, 1, 1, 1) a "ResNet-10", and the BatchNorm every
port model trains with.

Follows radar_sounder_crw_tpu/models/resnet.py (`BasicBlock`, `ResNetCore`,
`make_norm`: flax's rule, two-pass, and models/fused_bn.py's `fused` and
`lean`) with the plain 7x7/stride-2 stem only, and the eval-mode fold of
each BatchNorm into the convolution before it (`fold_conv_bn`, `conv_bn`);
the JAX package's space-to-depth stem and batch-minor layout are TPU layout
work and compute the same function. A convolution on a map of no more
pixels than its kernel has taps (on 16 x 16 patches `layer2.conv2`,
`layer3` and `layer4`'s 3x3 ones) is one dense linear map: its data and
weight gradients run as float32 GEMMs against its unrolled weight
(`SmallMapConv`; cuDNN has no fast float32 backward for these maps), and a
forward that autograd does not record runs as one such GEMM
(`small_map_conv`), the same sums less the products with the zero padding.
The stages' other convolutions whose input wants a gradient (`layer1`,
`layer2.conv1`, the 1x1 downsamples) take their gradients as float32
GEMMs on the im2col form (`Im2colGradConv`); every training forward
stays cuDNN's.
Submodule names are the reference state_dict names (`conv1`, `bn1`,
`layer2.0.downsample.0`, `fc`), so weights load with `strict=True`.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; flax momentum 0.9

small_map_convs = {"gemm": 0, "cudnn": 0}  # convolutions run by conv_bn: GEMM, other
# conv_bn calls that autograd records, by the route of their gradients:
# SmallMapConv, Im2colGradConv, cuDNN's (5, 6 and 2 a ResNet-10 forward on
# 16 x 16 patches; 0 without autograd and in the fold)
conv_grad_routes = {"unrolled": 0, "im2col": 0, "cudnn": 0}
_selections: dict = {}  # small-map selection tensors (_selection)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's `nn.BatchNorm` rule in train mode.

    In train mode the batch statistics are computed in float32 (whatever
    the input dtype; a float64 input in float64), the variance one-pass as
    max(0, E[x^2] - E[x]^2) (flax's `use_fast_variance=True`; `twopass=True`
    gives E[(x - mean)^2]), the output is
    (x - mean) * (rsqrt(var + eps) * weight) + bias, and the running
    statistics blend the BIASED batch variance:
    r <- 0.9 r + 0.1 batch. `nn.BatchNorm2d` blends the unbiased one, n/(n-1)
    larger. The buffers are left alone when `track_running_stats` is False
    (`frozen_statistics`). In eval mode the module is `nn.BatchNorm2d` (a
    non-float32 input is normalised in float32 and cast back, as flax does).
    State-dict keys are those of `nn.BatchNorm2d`. Inside
    `cross_rank_statistics` the batch statistics are those of the batch of
    every rank of a mesh (`stats_mesh`)."""

    stats_mesh = None  # set by cross_rank_statistics only

    def __init__(self, channels: int, twopass: bool = False):
        super().__init__(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.twopass = twopass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if x.dtype == torch.float32:
                return super().forward(x)
            return super().forward(x.float()).to(x.dtype)
        xf = x if x.dtype == torch.float64 else x.float()
        if self.stats_mesh is not None:
            mean, var = _cross_rank_moments(xf, self.stats_mesh, self.twopass)
        elif self.twopass:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
        self._track(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Blend the batch statistics into the running ones (flax's rule),
        unless `track_running_stats` is off."""
        if self.track_running_stats:
            decay = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(decay * self.running_mean + self.momentum * mean)
                self.running_var.copy_(decay * self.running_var + self.momentum * var)
                self.num_batches_tracked.add_(1)


def _cross_rank_moments(xf: torch.Tensor, mesh, twopass: bool):
    """Per-channel mean and biased variance, at xf's dtype, of the batch of
    every rank of `mesh` (equal shards, so the batch's moments are the mean
    of the ranks'): flax's one-pass rule from E[x] and E[x^2] all-reduced
    in one call, or with `twopass` E[x] first, then E[(x - mean)^2]. The
    all-reduce carries the gradient; over one rank the arithmetic is the
    local rule's, bit for bit."""
    dims = (0, 2, 3)
    if twopass:
        mean = all_reduce_sum(xf.mean(dim=dims), mesh) / mesh.size
        var = all_reduce_sum((xf - mean[:, None, None]).square().mean(dim=dims), mesh) / mesh.size
        return mean, var
    moments = all_reduce_sum(torch.stack([xf.mean(dim=dims), xf.square().mean(dim=dims)]),
                             mesh) / mesh.size
    return moments[0], (moments[1] - moments[0].square()).clamp_min(0.0)


def make_norm(fused_bn, channels: int) -> BatchNorm:
    """The BatchNorm factory of the JAX package's `make_norm`
    (radar_sounder_crw_tpu/models/resnet.py): flax's rule, the one-pass
    variance (None/False), its two-pass variance ('twopass'), the
    hand-scheduled `FusedBatchNorm` (True/'fused') or the bf16-read
    `LeanBatchNorm` ('lean') of models/fused_bn.py. State-dict keys are the
    same for all four."""
    from .fused_bn import FusedBatchNorm, LeanBatchNorm

    if fused_bn in (None, False):
        return BatchNorm(channels)
    if fused_bn == "twopass":
        return BatchNorm(channels, twopass=True)
    if fused_bn in (True, "fused"):
        return FusedBatchNorm(channels)
    if fused_bn == "lean":
        return LeanBatchNorm(channels)
    raise ValueError(f"unknown BatchNorm implementation {fused_bn!r}")


@contextlib.contextmanager
def cross_rank_statistics(model: nn.Module, mesh):
    """Every BatchNorm of `model` takes its train-mode batch statistics over
    all ranks of `mesh`, each rank holding an equal shard of the batch: the
    statistics, the normalisation and the running statistics are then those
    of the whole batch on one device. Only a trainer's sharded step enters
    it; a replicated partial batch, eval and `bn_train_mode` inference keep
    their statistics to their own rank."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.stats_mesh = mesh
    try:
        yield
    finally:
        for m in bns:
            m.stats_mesh = None


@contextlib.contextmanager
def frozen_statistics(model: nn.Module):
    """Every BatchNorm of `model` leaves its running statistics alone
    (`track_running_stats` off): train mode then normalises with the batch's
    statistics and updates nothing, as flax's `apply(train=True)` with the
    updated collection discarded. It serves the recompute of an
    activation-checkpointed forward (jax.checkpoint has no such side effect
    to repeat) and `bn_train_mode` inference."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    saved = [m.track_running_stats for m in bns]
    for m in bns:
        m.track_running_stats = False
    try:
        yield
    finally:
        for m, track in zip(bns, saved):
            m.track_running_stats = track


def f32_head(fc: nn.Module, feat: torch.Tensor) -> torch.Tensor:
    """A head layer in float32 outside any autocast region, as the JAX
    package's heads run with dtype=float32 whatever the encoder's dtype."""
    with torch.autocast(feat.device.type, enabled=False):
        return fc(feat.float())


def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """`conv` followed by `bn` in eval mode as one convolution's (weight,
    bias): W' = W s and b' = (b - running_mean) s + beta per output channel,
    s = gamma / sqrt(running_var + eps), b = 0 where `conv` has no bias;
    computed in float64, stored in float32."""
    with torch.no_grad():
        s = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
        shift = -bn.running_mean.double()
        if conv.bias is not None:
            shift = shift + conv.bias.double()
        weight = conv.weight.double() * s[:, None, None, None]
        return weight.float(), (shift * s + bn.bias.double()).float()


def _plain(conv: nn.Conv2d) -> bool:
    """A dense, undilated convolution with numeric zero padding."""
    return (conv.groups == 1 and conv.dilation == (1, 1) and conv.padding_mode == "zeros"
            and not isinstance(conv.padding, str))


def small_map(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """Whether `conv` on `x` takes the small-map GEMMs (`SmallMapConv`,
    `small_map_conv`): a dense, undilated, zero-padded convolution whose
    kernel has more than one tap and at least as many taps as the input map
    has pixels, so that the dense product does no more multiply-adds than
    the convolution."""
    kh, kw = conv.kernel_size
    return _plain(conv) and 1 < kh * kw and x.shape[-2] * x.shape[-1] <= kh * kw


def _out_hw(conv: nn.Conv2d, height: int, width: int) -> tuple[int, int]:
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    return (height + 2 * ph - kh) // sh + 1, (width + 2 * pw - kw) // sw + 1


def _selection(conv: nn.Conv2d, height: int, width: int, device, dtype) -> torch.Tensor:
    """S[q, p, t] = 1 where tap t of `conv`'s kernel links input pixel q of
    a height x width map to output pixel p, else 0 (the zero padding);
    built on the host once per geometry, device and dtype, and kept (a CUDA
    graph may hold it)."""
    key = (conv.kernel_size, conv.stride, conv.padding, height, width, device, dtype)
    sel = _selections.get(key)
    if sel is None:
        (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
        oh, ow = _out_hw(conv, height, width)
        sel = torch.zeros(height * width, oh * ow, kh * kw, dtype=dtype)
        for p in range(oh * ow):
            for t in range(kh * kw):
                i, j = p // ow * sh - ph + t // kw, p % ow * sw - pw + t % kw
                if 0 <= i < height and 0 <= j < width:
                    sel[i * width + j, p, t] = 1
        sel = _selections[key] = sel.to(device)
    return sel


def small_map_operands(conv: nn.Conv2d, weight: torch.Tensor, bias, height: int,
                       width: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """`conv` with `weight` and `bias` on a height x width map as a dense
    matrix and a row: Wbig[(c, q), (k, p)] is the tap that links input pixel
    q of channel c to output pixel p of channel k, or 0, and the bias is
    repeated over the output pixels (None without one). Each entry of Wbig
    is one weight or 0, picked by a 0/1 selection: exact."""
    cout, cin, kh, kw = weight.shape
    sel = _selection(conv, height, width, weight.device, weight.dtype)
    big = torch.einsum("kct,qpt->cqkp", weight.reshape(cout, cin, kh * kw), sel)
    big = big.reshape(cin * sel.shape[0], cout * sel.shape[1])
    return big, None if bias is None else bias.repeat_interleave(sel.shape[1])


def small_map_conv(conv: nn.Conv2d, x: torch.Tensor, operands) -> torch.Tensor:
    """`conv`'s convolution of `x`, where `small_map(conv, x)`, as one GEMM
    with `operands` (`small_map_operands` at x's map size): x as (N, Cin *
    H * W), already that order in NCHW, times Wbig, plus the repeated bias,
    is the (N, Cout * h * w) output in NCHW order. Only the products with
    the zero padding are left out."""
    big, bias = operands
    x2 = x.reshape(x.shape[0], -1)
    y = torch.mm(x2, big) if bias is None else torch.addmm(bias, x2, big)
    return y.reshape(x.shape[0], -1, *_out_hw(conv, x.shape[-2], x.shape[-1]))


class SmallMapConv(torch.autograd.Function):
    """`conv`'s convolution of `x` where `small_map(conv, x)`, as autograd
    records it: the forward is cuDNN's (`F.conv2d`), bit for bit the plain
    route's, and the gradients are GEMMs against the unrolled weight,
    dx = g Wbig^T and dWbig = x^T g, folded back onto the taps by the
    selection: fixed-order sums, no atomics. The GEMMs run in the dtype the
    convolution ran in (bfloat16 under autocast). The forward stays cuDNN's
    so that a training step's forward rounds as the plain route's does:
    Adam's first step moves each weight by the sign of its gradient, and a
    forward rounded otherwise flips the signs of gradients near zero; three
    CRW steps then land 2e-5 to 5e-5 apart in loss, against 2e-6 to 6e-6
    between cuDNN's own algorithms (ResNet-10, B 8, T 20, H100).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, conv):
        y = F.conv2d(x, weight, bias, conv.stride, conv.padding)
        ctx.conv, ctx.dtype, ctx.has_bias = conv, y.dtype, bias is not None
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        cout, cin = weight.shape[:2]
        dt = ctx.dtype
        with torch.autocast(x.device.type, enabled=False):
            big, _ = small_map_operands(ctx.conv, weight.to(dt), None, *x.shape[-2:])
            sel = _selection(ctx.conv, x.shape[-2], x.shape[-1], weight.device, dt)
            q, p = sel.shape[:2]
            g2 = gy.to(dt).reshape(gy.shape[0], cout * p)
            dx = torch.mm(g2, big.t()).reshape(x.shape)
            dbig = torch.mm(x.to(dt).reshape(x.shape[0], cin * q).t(), g2)
            dw = torch.einsum("cqkp,qpt->kct", dbig.reshape(cin, q, cout, p), sel)
            db = g2.reshape(-1, cout, p).sum((0, 2)) if ctx.has_bias else None
        return dx.to(x.dtype), dw.reshape(weight.shape).to(weight.dtype), \
            None if db is None else db.to(weight.dtype), None


def im2col_columns(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The im2col form of `conv`'s input x (N, Cin, H, W) as one (Cin·kh·kw,
    N·L) matrix, L = h·w output pixels, rows in the order of the weight's
    (Cin, kh, kw): a strided view of the zero-padded x, copied once.
    `F.unfold` gives the same entries, but on CUDA launches one kernel a
    sample (18,080 a call in a CRW step at B 8, T 20, N 113)."""
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    n, cin = x.shape[:2]
    oh, ow = _out_hw(conv, *x.shape[-2:])
    xp = F.pad(x, (pw, pw, ph, ph)).contiguous()
    sn, sc, sy, sx = xp.stride()
    view = xp.as_strided((cin, kh, kw, n, oh, ow), (sc, sy, sx, sn, sy * sh, sx * sw))
    return view.reshape(cin * kh * kw, n * oh * ow)


def im2col_fold(conv: nn.Conv2d, cols: torch.Tensor, n: int, height: int,
                width: int) -> torch.Tensor:
    """The adjoint of `im2col_columns` (col2im): the (Cin·kh·kw, N·L)
    columns summed back onto an (N, Cin, height, width) map, one strided add
    a tap in the kernel's order: fixed-order sums, no atomics (faster on an
    H100 at the CRW step's shapes than `F.fold`'s gather)."""
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    oh, ow = _out_hw(conv, height, width)
    taps = cols.reshape(-1, kh, kw, n, oh, ow)
    out = cols.new_zeros(n, taps.shape[0], height + 2 * ph, width + 2 * pw)
    for i in range(kh):
        for j in range(kw):
            out[:, :, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw] += \
                taps[:, i, j].transpose(0, 1)
    return out[:, :, ph:ph + height, pw:pw + width]


class Im2colGradConv(torch.autograd.Function):
    """`conv`'s convolution of `x` as autograd records it, where
    `im2col_grad(conv, x)` (on 16 x 16 patches `layer1`, `layer2.conv1` and
    the three 1x1 downsamples): the forward is cuDNN's
    (`F.conv2d`), bit for bit the plain route's, for the reason
    `SmallMapConv` gives; the gradients are GEMMs on the im2col form over
    all N·L output positions, g as (Cout, N·L) and x's columns
    (`im2col_columns`) as (Cin·kh·kw, N·L): dW = g colsᵀ, and dx is
    Wᵀ g folded back onto the map (`im2col_fold`). Every sum has a fixed
    order, so two backward passes are bit-equal. The GEMMs run in the dtype
    the convolution ran in (bfloat16 under autocast). At layer1's 5 x 5
    maps the unrolled weight of `SmallMapConv` would be 73 % zeros, and
    cuDNN's float32 backward there is its FFT and legacy engines."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv):
        y = F.conv2d(x, weight, bias, conv.stride, conv.padding)
        ctx.conv, ctx.dtype, ctx.has_bias = conv, y.dtype, bias is not None
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        conv, dt = ctx.conv, ctx.dtype
        n, cout = gy.shape[:2]
        dx = dw = db = None
        with torch.autocast(x.device.type, enabled=False):
            g = gy.to(dt).transpose(0, 1).reshape(cout, -1)
            if ctx.needs_input_grad[0]:
                dcols = torch.mm(weight.to(dt).reshape(cout, -1).t(), g)
                dx = im2col_fold(conv, dcols, n, *x.shape[-2:]).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.mm(g, im2col_columns(conv, x.to(dt)).t())
                dw = dw.reshape(weight.shape).to(weight.dtype)
            if ctx.has_bias and ctx.needs_input_grad[2]:
                db = g.sum(1).to(weight.dtype)
        return dx, dw, db, None


def im2col_grad(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """Whether `conv` on `x`, recorded by autograd and not `small_map`,
    takes `Im2colGradConv`: a dense, undilated, zero-padded convolution of
    at most 3 x 3 (the stages' convolutions) whose input wants a gradient.
    A convolution of the data alone (the encoder's `fc0`) keeps cuDNN's
    weight gradient. So does the stem's 7x7: its data gradient feeds the
    eps-sized, all-cancellation gradients of `fc0` and `bn0`, whose signs
    Adam's first step follows, and on the GEMMs it moved a CRW step at
    B 8, T 20 off the float32 reference's loss by 3.2e-5 (one seed of 20,
    H100), where cuDNN's gradient there read 1.7e-6 and the stages'
    convolutions on the GEMMs at most 7.0e-6 over the 20."""
    return _plain(conv) and max(conv.kernel_size) <= 3 and x.requires_grad


def conv_bn(conv: nn.Conv2d, bn: nn.Module, x: torch.Tensor, fold=None) -> torch.Tensor:
    """bn(conv(x)); with `fold` (conv -> `fold_conv_bn(conv, bn)`) the one
    convolution that equals it in eval mode. A convolution on a map of no
    more pixels than its kernel has taps (`small_map`) takes
    `SmallMapConv` where autograd records it, else one GEMM,
    `small_map_conv` (the fold keeps its operands under (conv, H, W)); any
    other runs on `conv` / `F.conv2d`, recorded by autograd through
    `Im2colGradConv` where its input wants a gradient (`im2col_grad`). The
    forward autograd records is cuDNN's on every route: its gradients may
    round otherwise, its forward may not (`SmallMapConv`).
    `small_map_convs` counts the forward's routes, `conv_grad_routes` the
    gradients' of each recorded call."""
    gemm = small_map(conv, x)
    small_map_convs["gemm" if gemm else "cudnn"] += 1
    if fold is None:
        if torch.is_grad_enabled() and (x.requires_grad or conv.weight.requires_grad):
            route = "unrolled" if gemm else "im2col" if im2col_grad(conv, x) else "cudnn"
            conv_grad_routes[route] += 1
            if route == "unrolled":
                return bn(SmallMapConv.apply(x, conv.weight, conv.bias, conv))
            if route == "im2col":
                return bn(Im2colGradConv.apply(x, conv.weight, conv.bias, conv))
            return bn(conv(x))
        if not gemm:
            return bn(conv(x))
        operands = small_map_operands(conv, conv.weight, conv.bias, *x.shape[-2:])
        return bn(small_map_conv(conv, x, operands))
    weight, bias = fold[conv]
    if not gemm:
        return F.conv2d(x, weight, bias, conv.stride, conv.padding, conv.dilation, conv.groups)
    key = (conv, *x.shape[-2:])
    if key not in fold:
        fold[key] = small_map_operands(conv, weight, bias, *x.shape[-2:])
    return small_map_conv(conv, x, fold[key])


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual connection (expansion 1)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, use_projection: bool = False,
                 fused_bn=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = make_norm(fused_bn, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = make_norm(fused_bn, planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                make_norm(fused_bn, planes),
            )
            if use_projection
            else None
        )

    def forward(self, x: torch.Tensor, fold=None) -> torch.Tensor:
        identity = x if self.downsample is None else conv_bn(*self.downsample, x, fold)
        y = self.relu(conv_bn(self.conv1, self.bn1, x, fold))
        y = conv_bn(self.conv2, self.bn2, y, fold)
        return self.relu(y + identity)


class ResNetCore(nn.Module):
    """Stem + four BasicBlock stages + global average pool + linear head."""

    def __init__(
        self,
        stage_sizes: Sequence[int] = (1, 1, 1, 1),
        num_classes: int = 128,
        width: int = 64,
        in_channels: int = 3,
        fused_bn=None,
    ):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = make_norm(fused_bn, width)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, planes = width, width
        for stage, nblocks in enumerate(stage_sizes):
            blocks = []
            for block in range(nblocks):
                first = stage > 0 and block == 0
                blocks.append(BasicBlock(inplanes, planes, stride=2 if first else 1,
                                         use_projection=first, fused_bn=fused_bn))
                inplanes = planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(inplanes, num_classes)

    def blocks(self) -> list[BasicBlock]:
        """The BasicBlocks of every stage, in order."""
        return [block for stage in range(self.num_stages)
                for block in getattr(self, f"layer{stage + 1}")]

    def conv_bn_pairs(self) -> list[tuple[nn.Conv2d, nn.Module]]:
        """Every BatchNorm with the convolution whose output it normalises."""
        pairs = [(self.conv1, self.bn1)]
        for block in self.blocks():
            pairs += [(block.conv1, block.bn1), (block.conv2, block.bn2)]
            if block.downsample is not None:
                pairs.append(tuple(block.downsample))
        return pairs

    def features(self, x: torch.Tensor, fold=None) -> torch.Tensor:
        """Everything before the head: the globally pooled (B, C) map;
        `fold` as in `conv_bn`."""
        x = self.maxpool(self.relu(conv_bn(self.conv1, self.bn1, x, fold)))
        for block in self.blocks():
            x = block(x, fold)
        return x.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return f32_head(self.fc, self.features(x))
