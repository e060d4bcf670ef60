"""The JAX package's two hand-scheduled train-mode BatchNorms
(radar_sounder_crw_tpu/models/fused_bn.py), selected by `fused_bn` in
models/resnet.py `make_norm`.

  * `FusedBatchNorm` (True / 'fused'): `bn_train`, an autograd Function
    whose forward is the statistics and normalize kernels and whose backward
    is the two backward kernels of csrc/bn_train.cu (ops/bn_cuda.py). Its
    numerics are the JAX module's own: the batch variance E[x^2] - E[x]^2
    with no clamp, y = ((x - mean) * inv) * scale + bias in float32 cast to
    x's dtype, and a backward that drops the cotangents of mean and var.
  * `LeanBatchNorm` ('lean'): the statistics kernel inside a small autograd
    Function (E[x], E[x^2] in float32, read from x in its stored dtype;
    backward the elementwise d(E[x], E[x^2])/dx); the clamp
    max(0, E[x^2] - E[x]^2), the normalize and its gradient stay in
    PyTorch ops, derived by autograd as XLA derives them. It spares the
    float32 copy of the activation that `BatchNorm.forward` makes.

Both subclass the port's `BatchNorm`: the same state-dict keys (so
`state_dict_from_jax` and strict loading work unchanged), the same eval
mode, the flax running-statistics rule (momentum 0.9, from the biased
variance), left alone under `frozen_statistics`, and batch statistics over
every rank inside `cross_rank_statistics`: `bn_train` all-reduces its sums
and the count in one call in the forward and the backward's sums before the
input gradient (what XLA's SPMD partitioning does to the JAX custom_vjp's
sums); `LeanBatchNorm` all-reduces its moments through the differentiable
`all_reduce_sum`. Over one rank both equal the local rule bit for bit.

On CPU tensors the kernels' plain twins run; on the card the kernels do,
and a build or launch failure raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import bn_cuda
from ..parallel.mesh import all_reduce_sum
from .resnet import BatchNorm


class _BNTrain(torch.autograd.Function):
    """(x, scale, bias) -> (y, mean, var); mean and var carry no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, group):
        sums = bn_cuda.stats(x)
        if group is not None:
            dist.all_reduce(sums, group=group)  # (sum x, sum x^2, n) of every rank
        y, mean, var = bn_cuda.apply(x, sums, scale, bias, eps)
        ctx.save_for_backward(x, scale, sums)
        ctx.eps, ctx.group = eps, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, sums = ctx.saved_tensors
        gsums = bn_cuda.backward_reduce(gy, x, sums, ctx.eps)
        total = gsums
        if ctx.group is not None:
            total = gsums.clone()
            dist.all_reduce(total, group=ctx.group)
        dx = bn_cuda.dx(gy, x, sums, total, scale, ctx.eps)
        C = x.shape[1]
        # this rank's share of dscale = sum g * xhat and dbias = sum g (the
        # trainer sums parameter gradients over the ranks)
        return dx, gsums[C:], gsums[:C], None, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float, mesh=None):
    """Train-mode BatchNorm of x (N, C, H, W): (y in x's dtype, mean, var),
    the statistics over every rank of `mesh` when one is given."""
    return _BNTrain.apply(x, scale, bias, eps, None if mesh is None else mesh.group)


class _Moments(torch.autograd.Function):
    """x -> (2, C) float32: E[x] and E[x^2] per channel."""

    @staticmethod
    def forward(ctx, x):
        C = x.shape[1]
        sums = bn_cuda.stats(x)
        n = sums[2 * C]
        ctx.save_for_backward(x, n)
        return sums[: 2 * C].view(2, C) / n

    @staticmethod
    def backward(ctx, gm):
        x, n = ctx.saved_tensors
        C = x.shape[1]
        a, b = (gm / n).reshape(2, 1, C, 1, 1)
        return (a + b * (2 * x.float())).to(x.dtype)


class FusedBatchNorm(BatchNorm):
    """`BatchNorm` whose train mode is `bn_train` (the JAX FusedBatchNorm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, var = bn_train(x, self.weight, self.bias, self.eps, self.stats_mesh)
        self._track(mean, var)
        return y


class LeanBatchNorm(BatchNorm):
    """`BatchNorm` whose train-mode statistics read x in its stored dtype
    (the JAX LeanBatchNorm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        moments = _Moments.apply(x)
        if self.stats_mesh is not None:
            moments = all_reduce_sum(moments, self.stats_mesh) / self.stats_mesh.size
        mean, mean2 = moments[0], moments[1]
        var = torch.maximum(mean2 - mean * mean, mean.new_zeros(()))
        self._track(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)
