"""The yardstick's arithmetic held to PyTorch's own operation counter on the
port's encoder and training step, on the CPU."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import arith


def _count(fn) -> int:
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


def test_encoder_forward_per_patch():
    from radar_sounder_crw_tpu_torch.models import create_model

    model = create_model(1, False, device="cpu")
    x = torch.randn(3, 1, 16, 16)
    assert _count(lambda: model(x)) == 3 * arith.encoder_flops(16, 16)
    assert round(arith.encoder_flops(16, 16) / 1e6, 1) == 24.2


def test_encoder_forward_backward_per_patch():
    from radar_sounder_crw_tpu_torch.models import create_model

    model = create_model(1, False, device="cpu").train()
    x = torch.randn(3, 1, 16, 16)
    assert _count(lambda: model(x).sum().backward()) == 3 * arith.encoder_flops(16, 16, True)


def test_crw_loss():
    from radar_sounder_crw_tpu_torch.ops.crw import crw_loss

    for B, T, N in ((2, 6, 5), (1, 4, 3), (2, 3, 4)):
        emb = torch.randn(B, T, N, 128, requires_grad=True)
        assert _count(lambda: crw_loss(emb, 0.01)[0].backward()) == arith.crw_loss_flops(B, T, N)


def test_bench_step_total():
    """The CRW step at B 8, T 20, N 113: 1314.9 GFLOP (PERF.md)."""
    assert round(arith.train_step_flops(8, 20, 113) / 1e9, 1) == 1314.9


def test_propagation_counts():
    ops, nbytes = arith.step_flops_bytes(101, 50, 128, 6, 20, 11)
    assert ops == 2 * 11 * 50 * 50 * 128 + 3 * 11 * 50 * 50 + 2 * 50 * 20 * 6
    assert nbytes == 4 * (11 * 50 * 128 + 50 * 128 + 2500 + 101 + 11 * 50 * 6 + 50 * 6)
    seq_ops, _ = arith.seq_flops_bytes(2, 5, 50, 128, 6, 20, 1, 3)
    frame_ops, _ = arith.frames_flops_bytes(5, 50, 128, 6, 20, 1, 3)
    assert seq_ops == 2 * frame_ops
    assert arith.bound_seconds(67e12, 0) == 1.0 and arith.bound_seconds(0, 3.35e12) == 1.0
