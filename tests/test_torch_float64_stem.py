"""The ResNet encoder's stem (`fc0`, a 1x1 convolution with padding 1, and
`bn0`) in float64 while training with the two-pass BatchNorm
(models/encoders.py `ResNetEncoder._stem`), on the CPU.

bn0's batch statistics make the stem invariant to fc0's scale, so fc0's
true weight gradient is eps-sized and all cancellation. The gradient is
held against one the test computes in float64 from the same upstream
gradient, on four inits and at 1, 2 and 4 threads: the float64 stem reads
<= 2e-8 there, a float32 stem 1.3e-4 to 1.1e-2. The stem's forward is
held to the float64 one within float32's rounding, and the other
forwards, training with the one-pass rule among them, keep float32."""

import pytest
import torch
import torch.nn.functional as F

from radar_sounder_crw_tpu_torch.models import create_model, resnet
from radar_sounder_crw_tpu_torch.models.encoders import ResNetEncoder

FC0_GRAD_LIMIT = 1e-5  # the float64 stem reads <= 2e-8, a float32 one >= 1.3e-4


def _stem64(enc, x, twopass):
    """bn0(fc0(x)) in float64 with flax's train-mode rule (biased variance,
    one- or two-pass), written out here."""
    w = enc.fc0.weight.detach().double().requires_grad_()
    z = F.conv2d(x.double(), w, enc.fc0.bias.detach().double(), padding=1)
    mean = z.mean(dim=(0, 2, 3))
    if twopass:
        var = (z - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    else:
        var = (z.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + enc.bn0.eps) * enc.bn0.weight.detach().double()
    shift = enc.bn0.bias.detach().double()
    y = (z - mean[:, None, None]) * mul[:, None, None] + shift[:, None, None]
    return y, w


def _rel(a, b):
    return float((a.double() - b).norm() / b.norm())


@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("fused_bn", ["twopass"])
def test_fc0_weight_gradient_against_float64(fused_bn, threads):
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for seed in range(4):
            torch.manual_seed(seed)
            enc = ResNetEncoder(fused_bn=fused_bn).train()
            with torch.no_grad():  # a bias ~1 against a spread ~0.2, as the JAX init gives
                enc.fc0.bias.uniform_(-1.0, 1.0)
            x = torch.randn(4, 1, 16, 16)
            g = torch.randn(4, 3, 18, 18)
            y = enc._stem(x, None)
            y.backward(g)
            y64, w64 = _stem64(enc, x, fused_bn == "twopass")
            y64.backward(g.double())
            assert y.dtype == torch.float32
            assert _rel(y.detach(), y64.detach()) < 1e-6
            err = _rel(enc.fc0.weight.grad, w64.grad)
            assert err < FC0_GRAD_LIMIT, f"seed {seed}: {err:.2e}"
    finally:
        torch.set_num_threads(saved)


def _bn0_input_dtype(enc, x):
    seen = []
    hook = enc.bn0.register_forward_hook(lambda m, inp, out: seen.append(inp[0].dtype))
    enc(x)
    hook.remove()
    return seen[0]


@pytest.mark.parametrize("fused_bn", ["twopass"])
def test_training_takes_the_float64_stem(fused_bn):
    enc = ResNetEncoder(fused_bn=fused_bn).train()
    assert _bn0_input_dtype(enc, torch.randn(2, 1, 16, 16)) == torch.float64


@pytest.mark.parametrize("case", ["eval", "bn_train_mode", "one_pass", "fused", "lean",
                                  "bfloat16"])
def test_other_forwards_keep_the_float32_stem(case):
    enc = ResNetEncoder(fused_bn=case if case in ("fused", "lean") else None)
    enc.train(case in ("one_pass", "fused", "lean", "bfloat16"))
    if case == "bn_train_mode":  # an eval encoder whose BatchNorms take batch statistics
        for m in enc.modules():
            if isinstance(m, resnet.BatchNorm):
                m.train()
    if case == "bfloat16":
        enc.compute_dtype = torch.bfloat16
    want = torch.bfloat16 if case == "bfloat16" else torch.float32
    assert _bn0_input_dtype(enc, torch.randn(2, 1, 16, 16)) == want


def test_the_float64_stem_keeps_the_running_statistics_float32():
    enc = create_model(1, False, device="cpu", fused_bn="twopass").train()
    enc(torch.randn(2, 1, 16, 16))
    assert enc.bn0.running_mean.dtype == enc.bn0.running_var.dtype == torch.float32
    assert enc.fc0.weight.dtype == torch.float32
