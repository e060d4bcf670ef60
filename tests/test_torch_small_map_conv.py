"""The ResNet's small-map convolutions as GEMMs (models/resnet.py
`small_map`, `small_map_operands`, `small_map_conv`, `SmallMapConv`,
through `conv_bn`), on the CPU: against `F.conv2d` forward and backward,
the shape rule, the `small_map_convs` counter, and the weight gradient's
bits repeating."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from radar_sounder_crw_tpu_torch.models import create_model, resnet
from radar_sounder_crw_tpu_torch.models.unet import UNet

# (cin, cout, kernel, stride, padding, map): the ResNet-10's five small maps
# on 16 x 16 patches at odd channel counts, and other geometries the rule takes
GEOMETRIES = [
    (5, 7, 3, 1, 1, 3),  # layer2.conv2: 3 x 3 -> 3 x 3
    (5, 9, 3, 2, 1, 3),  # layer3.conv1: 3 x 3 -> 2 x 2
    (9, 9, 3, 1, 1, 2),  # layer3.conv2: 2 x 2 -> 2 x 2
    (9, 11, 3, 2, 1, 2),  # layer4.conv1: 2 x 2 -> 1 x 1
    (11, 11, 3, 1, 1, 1),  # layer4.conv2: 1 x 1 -> 1 x 1
    (3, 5, 3, 2, 1, 1),  # 1 x 1 at stride 2
    (3, 4, 5, 1, 2, 3),  # a 5 x 5 kernel on 3 x 3
    (3, 4, (1, 3), (1, 2), (0, 1), (1, 3)),  # a 1 x 3 kernel on a 1 x 3 map
]
TOLERANCE = {torch.float64: 1e-12, torch.float32: 2e-6}


def _conv(cin, cout, kernel, stride, padding, bias, dtype, seed=0):
    torch.manual_seed(seed)
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=bias).to(dtype)


def _routes(conv, x, g):
    """{route: [y, dx, dw, db]} for cotangent g: 'forward', the GEMM that
    runs where autograd records nothing (output only); 'train',
    `SmallMapConv` through `conv_bn`; 'conv2d', `F.conv2d`."""
    out = {}
    with torch.no_grad():
        out["forward"] = [resnet.small_map_conv(conv, x, resnet.small_map_operands(
            conv, conv.weight, conv.bias, x.shape[-2], x.shape[-1])), None, None, None]
    for route in ("train", "conv2d"):
        xi = x.detach().requires_grad_(True)
        conv.zero_grad(set_to_none=True)
        if route == "train":
            y = resnet.conv_bn(conv, nn.Identity(), xi)
        else:
            y = F.conv2d(xi, conv.weight, conv.bias, conv.stride, conv.padding)
        (y * g).sum().backward()
        out[route] = [y.detach(), xi.grad, conv.weight.grad,
                      None if conv.bias is None else conv.bias.grad]
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cin,cout,kernel,stride,padding,size", GEOMETRIES)
def test_small_map_conv_matches_conv2d(cin, cout, kernel, stride, padding, size, bias, dtype):
    """The GEMM forward, and `SmallMapConv`'s data, weight and bias
    gradients, equal F.conv2d's to float64 rounding, and to float32's
    relative to the largest magnitude; `SmallMapConv`'s forward is
    F.conv2d's, bit for bit."""
    conv = _conv(cin, cout, kernel, stride, padding, bias, dtype)
    hw = size if isinstance(size, tuple) else (size, size)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(6, cin, *hw, generator=gen, dtype=dtype)
    assert resnet.small_map(conv, x)
    ref_shape = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding).shape
    g = torch.randn(ref_shape, generator=gen, dtype=dtype)
    got = _routes(conv, x, g)
    want = got.pop("conv2d")
    assert torch.equal(got["train"][0], want[0])
    assert got["forward"][0].shape == want[0].shape and got["forward"][0].is_contiguous()
    for route, results in got.items():
        for name, a, b in zip(("y", "dx", "dw", "db"), results, want):
            if a is None and (route == "forward" or b is None):
                continue
            assert a.dtype == b.dtype == dtype
            scale = b.abs().max().item() or 1.0
            assert (a - b).abs().max().item() <= TOLERANCE[dtype] * scale, (route, name)


@pytest.mark.parametrize("kernel,padding,size,stride,gemm", [
    (3, 1, 1, 1, True),
    (3, 1, 2, 1, True),
    (3, 1, 3, 1, True),
    (3, 1, 3, 2, True),
    (3, 1, (1, 9), 1, True),  # 9 pixels, 9 taps
    (3, 1, (2, 5), 1, False),  # 10 pixels, 9 taps
    (3, 1, 4, 1, False),
    (3, 1, 5, 1, False),  # layer1 and layer2.conv1 on 16 x 16 patches
    (3, 1, 5, 2, False),
    (1, 0, 1, 1, False),  # the 1 x 1 downsamples: one tap
    (1, 1, 1, 1, False),  # the stem's 1 x 1 convolution with padding 1
    (1, 0, 2, 2, False),
    (7, 3, 5, 2, True),  # 25 pixels under 49 taps
    (7, 3, 9, 2, False),  # the stem's 7 x 7 on 18 x 18 is far above
])
def test_the_rule_and_the_counter(kernel, padding, size, stride, gemm):
    """`small_map` holds exactly where H·W ≤ kh·kw and kh·kw > 1, and
    `conv_bn` counts the route it took, with and without autograd
    recording it, with equal outputs either way."""
    conv = _conv(4, 6, kernel, stride, padding, False, torch.float64)
    hw = size if isinstance(size, tuple) else (size, size)
    x = torch.randn(3, 4, *hw, dtype=torch.float64)
    assert resnet.small_map(conv, x) == gemm
    for grad in (True, False):
        before = dict(resnet.small_map_convs)
        with torch.set_grad_enabled(grad):
            y = resnet.conv_bn(conv, nn.Identity(), x)
        assert {k: resnet.small_map_convs[k] - before[k] for k in before} == \
            {"gemm": int(gemm), "cudnn": int(not gemm)}
        assert (y - conv(x)).abs().max().item() <= 1e-12


@pytest.mark.parametrize("change", [{"groups": 2}, {"dilation": 2}, {"padding_mode": "reflect"}])
def test_the_rule_refuses_other_convolutions(change):
    conv = nn.Conv2d(4, 6, 3, padding=1, **change)
    assert not resnet.small_map(conv, torch.zeros(1, 4, 2, 2))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("pos_embed", [False, True])
def test_one_resnet10_forward_runs_5_gemm_and_8_cudnn(train, pos_embed):
    """On 16 x 16 patches `layer2.conv2`, `layer3.conv1/2` and
    `layer4.conv1/2` take the GEMM; the stem's two convolutions, `layer1`,
    `layer2.conv1` and the three 1 x 1 downsamples take cuDNN's route; in
    train mode, in the plain eval forward and in the folded one alike."""
    model = create_model(1, pos_embed, device="cpu").train(train)
    x = torch.randn(4, 2 if pos_embed else 1, 16, 16)
    for grad in (True, False):
        before = dict(resnet.small_map_convs)
        with torch.set_grad_enabled(grad):
            model(x)
        assert {k: resnet.small_map_convs[k] - before[k] for k in before} == \
            {"gemm": 5, "cudnn": 8}


def test_the_cnn_and_the_unet_add_nothing_to_the_counter():
    before = dict(resnet.small_map_convs)
    create_model(0, True, device="cpu")(torch.randn(2, 2, 16, 16))
    UNet(1, 5)(torch.randn(1, 1, 32, 16))
    assert resnet.small_map_convs == before


def test_the_fold_keeps_the_gemm_operands():
    """The folded eval forward builds each small map's unrolled weight and
    repeated bias once, keeps them with the fold, and equals the plain eval
    forward (grad enabled) to float32 rounding."""
    model = create_model(1, True, device="cpu", seed=2)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    x = torch.randn(5, 2, 16, 16)
    with torch.no_grad():
        folded = model(x)
    fold = model._fold[1]
    kept = {k: v for k, v in fold.items() if isinstance(k, tuple)}
    assert sorted((k[0].in_channels, k[0].out_channels, k[1], k[2]) for k in kept) == [
        (128, 128, 3, 3), (128, 256, 3, 3), (256, 256, 2, 2), (256, 512, 2, 2), (512, 512, 1, 1)]
    for (conv, h, w), (big, bias) in kept.items():
        p = big.shape[1] // conv.out_channels
        assert big.shape == (conv.in_channels * h * w, conv.out_channels * p)
        assert torch.equal(bias, fold[conv][1].repeat_interleave(p))
    with torch.no_grad():
        again = model(x)
    assert torch.equal(again, folded)
    assert all(fold[k] is v for k, v in kept.items())
    plain = model(x).detach()
    assert (folded - plain).abs().max().item() <= 1e-5


def test_two_backward_passes_are_bit_equal():
    """The unrolled weight is a fixed-order contraction: the ResNet's
    gradients repeat their bits from one backward pass to the next."""
    model = create_model(1, False, device="cpu", seed=4).train()
    x = torch.randn(6, 1, 16, 16)
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        with resnet.frozen_statistics(model):
            model(x).square().sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_bfloat16_autocast_casts_the_gemm_as_the_convolution():
    """Under bfloat16 autocast the GEMM forward's output is bfloat16, as the
    convolution's is, and agrees with it to bfloat16 rounding;
    `SmallMapConv`'s forward is the convolution's, and its gradients come
    back in the parameters' and the input's float32, within bfloat16
    rounding of the convolution's."""
    conv = _conv(8, 8, 3, 1, 1, True, torch.float32)
    x = torch.randn(4, 8, 3, 3)
    g = torch.randn(4, 8, 3, 3)
    grads = {}
    with torch.autocast("cpu", dtype=torch.bfloat16):
        with torch.no_grad():
            got = resnet.small_map_conv(conv, x, resnet.small_map_operands(
                conv, conv.weight, conv.bias, 3, 3))
            want = conv(x)
        for route in ("train", "conv"):
            xi = x.detach().requires_grad_(True)
            conv.zero_grad(set_to_none=True)
            y = resnet.conv_bn(conv, nn.Identity(), xi) if route == "train" else conv(xi)
            assert y.dtype == torch.bfloat16
            (y.float() * g).sum().backward()
            grads[route] = (y.detach(), xi.grad, conv.weight.grad, conv.bias.grad)
    assert got.dtype == want.dtype == torch.bfloat16
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7 * scale
    assert torch.equal(grads["train"][0], grads["conv"][0])
    for a, b in zip(grads["train"][1:], grads["conv"][1:]):
        assert a.dtype == b.dtype == torch.float32
        assert (a - b).abs().max().item() <= 2 ** -6 * b.abs().max().item()
