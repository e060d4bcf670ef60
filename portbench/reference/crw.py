"""Plain Contrastive Random Walk training step: the upstream objective
(scripts/train.py, src/model.py) and Adam, in PyTorch.

Embeddings E (B, T, N, C) are L2-normalised; A_t = E_t E_t+1^T / tau. For
each depth k = 1..T-2 the walk P_k = sm(A_0^T) ... sm(A_k-1^T) sm(A_k-1) ...
sm(A_1) (row softmax; the first forward transition sm(A_0) is skipped, as
upstream does) goes into a cross-entropy against the identity that treats
P_k's rows as logits; the item's loss is the sum over depths divided by N,
and the batch's the mean over items. Adam is written out (PyTorch's
defaults: betas 0.9, 0.999, eps 1e-8). Nothing here imports the measured
program.
"""

from __future__ import annotations

import torch

from . import resnet


def _cycle_xent(P: torch.Tensor) -> torch.Tensor:
    return (torch.logsumexp(P, dim=-1) - torch.diagonal(P, dim1=-2, dim2=-1)).mean(dim=-1)


def crw_loss(emb: torch.Tensor, tau: float) -> torch.Tensor:
    """emb (B, T, N, C) -> the batch's scalar loss."""
    B, T, N, _ = emb.shape
    emb = emb * torch.rsqrt(emb.square().sum(-1, keepdim=True).clamp_min(1e-24))
    A = torch.einsum("btnc,btmc->btnm", emb[:, :-1], emb[:, 1:]) / tau
    fwd_sm = torch.softmax(A, dim=-1)
    bwd_sm = torch.softmax(A.transpose(-1, -2), dim=-1)
    total = torch.zeros(B, dtype=emb.dtype, device=emb.device)
    for k in range(1, T - 1):
        P = bwd_sm[:, 0]
        for j in range(1, k):
            P = P @ bwd_sm[:, j]
        for j in range(k - 1, 0, -1):
            P = P @ fwd_sm[:, j]
        total = total + _cycle_xent(P)
    return (total / N).mean()


class Adam:
    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt().add_(self.eps)
            params[k].sub_(self.lr * (self.m[k] / c1) / denom)


def train_step(params: dict, trainable: list, opt: Adam, batch: torch.Tensor, tau: float):
    """One step on batch (B, T, N, h, w): (loss, {name: gradient}); updates
    `params` in place (train-mode BatchNorm; running statistics are not
    compared and not kept)."""
    B, T, N, h, w = batch.shape
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in trainable}
    p = {**params, **leaves}
    emb = resnet.encode(p, batch.reshape(B * T * N, 1, h, w), train=True).reshape(B, T, N, -1)
    loss = crw_loss(emb, tau)
    grads = dict(zip(trainable, torch.autograd.grad(loss, [leaves[k] for k in trainable])))
    opt.step(params, grads)
    return float(loss.detach()), grads
