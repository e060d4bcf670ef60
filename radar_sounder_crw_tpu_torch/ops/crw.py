"""Contrastive Random Walk objective: the training loss.

Follows radar_sounder_crw_tpu/ops/crw.py. From per-frame, per-patch
embeddings E[b, t, n, :] (L2-normalized over channels), adjacent-frame
affinities are A[b, t] = E[b, t] @ E[b, t+1]^T / tau (N x N, t = 0..T-2).
For every palindrome depth k = 1..T-2 the walker takes the chain

    P_k = sm(A_0^T) sm(A_1^T) ... sm(A_{k-1}^T) sm(A_{k-1}) ... sm(A_1)

(`sm` = row softmax) and pays a cycle-consistency cross-entropy against the
identity; the total is (sum_k loss_k) / N. Two reference quirks are kept,
because they change the optimum: the forward transition of the first step,
sm(A_0), is skipped, and P_k, already row-stochastic, goes into a
cross-entropy that applies another row softmax (probabilities as logits).

`palindrome_walk_loss` reuses chain k's prefix products for chain k+1
(three batched N x N products a depth, O(T)); `palindrome_walk_loss_unrolled`
rebuilds each chain as the reference's left fold (O(T^2)). Everything here
runs in float32 outside autocast, whatever the encoder's compute dtype;
autograd gives the gradient.
"""

from __future__ import annotations

import torch


def _cycle_xent(P: torch.Tensor) -> torch.Tensor:
    """Per-item CE of each row of P against the identity, rows as logits:
    (B,), the mean over rows."""
    lse = torch.logsumexp(P, dim=-1)
    diag = torch.diagonal(P, dim1=-2, dim2=-1)
    return (lse - diag).mean(dim=-1)


def crw_affinity(emb: torch.Tensor, tau: float) -> torch.Tensor:
    """emb (B, T, N, C) L2-normalized -> A (B, T-1, N, N),
    A[b, t, n, m] = <emb[b, t, n], emb[b, t+1, m]> / tau, in float32."""
    emb = emb.float()
    return torch.einsum("btnc,btmc->btnm", emb[:, :-1], emb[:, 1:]) / tau


def palindrome_walk_loss(A: torch.Tensor, per_item: bool = False) -> torch.Tensor:
    """The loss from affinities A (B, T-1, N, N) by the O(T) prefix-product
    walk: the scalar (divided by N), or the (B,) per-item losses whose mean
    is the scalar. T = 2 has no depth and gives 0 with a defined gradient."""
    B, Tm1, N, _ = A.shape
    if Tm1 < 2:
        zero = A.sum(dim=(1, 2, 3)) * 0.0
        return zero if per_item else zero.sum()
    S_f = torch.softmax(A, dim=-1)  # sm(A_t)
    S_b = torch.softmax(A.transpose(-1, -2), dim=-1)  # sm(A_t^T)
    bwd = S_b[:, 0]  # depth 1: P_1 = sm(A_0^T)
    fwd = None  # the identity: sm(A_0) is skipped
    loss = _cycle_xent(bwd)
    for j in range(1, Tm1 - 1):  # depths 2..T-2
        bwd = torch.bmm(bwd, S_b[:, j])
        fwd = S_f[:, j] if fwd is None else torch.bmm(S_f[:, j], fwd)
        loss = loss + _cycle_xent(torch.bmm(bwd, fwd))
    per = loss / N
    return per if per_item else per.mean()


def palindrome_walk_loss_unrolled(A: torch.Tensor) -> torch.Tensor:
    """The reference's association: each depth-k chain as a strict left fold
    sm(AA_k[2k-1]) @ ... @ sm(AA_k[1]) @ I (O(T^2)); the scalar loss."""
    B, Tm1, N, _ = A.shape
    S_f = torch.softmax(A, dim=-1)
    S_b = torch.softmax(A.transpose(-1, -2), dim=-1)
    eye = torch.eye(N, dtype=A.dtype, device=A.device).expand(B, N, N)
    loss = A.new_zeros(())
    for k in range(1, Tm1):
        P = eye
        for j in range(1, k):
            P = torch.bmm(S_f[:, j], P)
        for j in range(k - 1, -1, -1):
            P = torch.bmm(S_b[:, j], P)
        loss = loss + _cycle_xent(P).mean()
    return loss / N


def crw_loss(emb: torch.Tensor, tau: float, only_a: bool = False, unrolled: bool = False,
             per_item: bool = False):
    """The CRW objective from raw embeddings emb (B, T, N, C): (loss, A),
    A the pre-softmax affinities; per_item gives (B,) losses; only_a returns
    A alone. Rows are normalized as emb * rsqrt(max(sumsq, 1e-24)), so an
    all-zero row gets a finite gradient (the norm's own is 0/0 there)."""
    with torch.autocast(emb.device.type, enabled=False):
        emb = emb.float()
        sumsq = emb.square().sum(dim=-1, keepdim=True)
        emb = emb * torch.rsqrt(sumsq.clamp_min(1e-24))
        A = crw_affinity(emb, tau)
        if only_a:
            return A
        if unrolled:
            return palindrome_walk_loss_unrolled(A), A
        return palindrome_walk_loss(A, per_item=per_item), A
