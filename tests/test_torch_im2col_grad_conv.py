"""The ResNet's convolutions whose gradients run as GEMMs on the im2col form
(models/resnet.py `Im2colGradConv`, `im2col_grad`, through `conv_bn`), on
the CPU: the im2col form against `F.unfold` and `F.fold`, the forward
bit for bit `F.conv2d`'s, the gradients against
float64 `F.conv2d`'s and `gradcheck`, their bits repeating, bfloat16 under
autocast, the rule and the `conv_grad_routes` counter, and one CRW step
against the step with cuDNN's gradients."""

import statistics

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from radar_sounder_crw_tpu_torch.models import create_model, resnet
from radar_sounder_crw_tpu_torch.models.unet import UNet
from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

# (cin, cout, kernel, stride, padding, map): the six convolutions of a
# ResNet-10 on 16 x 16 patches that take the route, and the stem's 7x7, which
# the rule leaves on cuDNN's gradients
GEOMETRIES = {
    "conv1": (3, 64, 7, 2, 3, 18),
    "layer1.conv1": (64, 64, 3, 1, 1, 5),
    "layer1.conv2": (64, 64, 3, 1, 1, 5),
    "layer2.conv1": (64, 128, 3, 2, 1, 5),
    "layer2.downsample": (64, 128, 1, 2, 0, 5),
    "layer3.downsample": (128, 256, 1, 2, 0, 3),
    "layer4.downsample": (256, 512, 1, 2, 0, 2),
}
TOLERANCE = {torch.float64: 1e-12, torch.float32: 2e-6}  # as test_torch_small_map_conv.py
ROUTES = ("unrolled", "im2col", "cudnn")


def _conv(cin, cout, kernel, stride, padding, bias, dtype, seed=0):
    torch.manual_seed(seed)
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=bias).to(dtype)


def _grads(conv, x, g, route):
    """(y, dx, dw, db) of `conv` on x for cotangent g: `Im2colGradConv`
    ('im2col') or `F.conv2d`."""
    xi = x.detach().requires_grad_(True)
    conv.zero_grad(set_to_none=True)
    if route == "im2col":
        y = resnet.Im2colGradConv.apply(xi, conv.weight, conv.bias, conv)
    else:
        y = F.conv2d(xi, conv.weight, conv.bias, conv.stride, conv.padding)
    (y * g).sum().backward()
    return [y.detach(), xi.grad, conv.weight.grad, None if conv.bias is None else conv.bias.grad]


def _counted(fn):
    before = dict(resnet.conv_grad_routes)
    out = fn()
    return out, {k: resnet.conv_grad_routes[k] - before[k] for k in ROUTES}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_forward_is_conv2d_and_gradients_match_float64(name, bias):
    """At each of the seven geometries: the forward equals `F.conv2d`'s bit
    for bit, and the data, weight and bias gradients in float32 lie within
    float32 rounding of float64 `F.conv2d`'s, relative to the largest
    magnitude. The rule takes all but the stem's 7x7."""
    cin, cout, kernel, stride, padding, size = GEOMETRIES[name]
    conv = _conv(cin, cout, kernel, stride, padding, bias, torch.float32)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, cin, size, size, generator=gen)
    assert not resnet.small_map(conv, x)
    assert resnet.im2col_grad(conv, x.requires_grad_(True)) == (name != "conv1")
    g = torch.randn(F.conv2d(x, conv.weight, None, stride, padding).shape, generator=gen)
    got = _grads(conv, x, g, "im2col")
    assert torch.equal(got[0], _grads(conv, x, g, "conv2d")[0])
    want = _grads(conv.double(), x.double(), g.double(), "conv2d")
    for what, a, b in zip(("y", "dx", "dw", "db"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == torch.float32
        scale = b.abs().max().item()
        assert (a.double() - b).abs().max().item() <= TOLERANCE[torch.float32] * scale, what


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_columns_and_fold_are_unfold_and_fold(name):
    """`im2col_columns` is `F.unfold`'s columns laid out as one (Cin·kh·kw,
    N·L) matrix, bit for bit, and `im2col_fold` is `F.fold` of the same
    layout (exact on a grid of 2**-4: every sum is exact)."""
    cin, cout, kernel, stride, padding, size = GEOMETRIES[name]
    conv = _conv(cin, cout, kernel, stride, padding, False, torch.float32)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(3, cin, size, size, generator=gen)
    shape = dict(kernel_size=kernel, stride=stride, padding=padding)
    cols = resnet.im2col_columns(conv, x)
    assert torch.equal(cols, F.unfold(x, **shape).transpose(0, 1).reshape(cols.shape))
    grid = torch.randint(-64, 64, cols.shape, generator=gen).float() / 16
    want = F.fold(grid.reshape(-1, 3, cols.shape[1] // 3).transpose(0, 1), (size, size), **shape)
    assert torch.equal(resnet.im2col_fold(conv, grid, 3, size, size), want)


@pytest.mark.parametrize("kernel,stride,padding,size", [
    (7, 2, 3, 9), (7, 1, 3, 8), (3, 1, 1, 5), (3, 2, 1, 5), (1, 2, 0, 5), (1, 1, 0, 4),
    (1, 1, 1, 3),  # fc0's geometry: a 1 x 1 kernel with padding 1
])
def test_gradcheck(kernel, stride, padding, size):
    """torch.autograd.gradcheck in float64, bias included, one small case
    for each kernel size and stride the ResNet has."""
    conv = _conv(2, 3, kernel, stride, padding, True, torch.float64)
    x = torch.randn(2, 2, size, size, dtype=torch.float64, requires_grad=True)
    assert not resnet.small_map(conv, x)
    assert torch.autograd.gradcheck(
        lambda x, w, b: resnet.Im2colGradConv.apply(x, w, b, conv), (x, conv.weight, conv.bias))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["conv1", "layer1.conv1", "layer2.conv1", "layer2.downsample"])
def test_conv_bn_route_matches_conv2d(name, dtype):
    """Through `conv_bn`, recorded with a data gradient, the route counts
    once as 'im2col' (the stem's 7x7 as 'cudnn') and gives `F.conv2d`'s
    output bit for bit and its gradients to the dtype's rounding."""
    cin, cout, kernel, stride, padding, size = GEOMETRIES[name]
    conv = _conv(cin, cout, kernel, stride, padding, False, dtype)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, cin, size, size, generator=gen, dtype=dtype)
    xi = x.clone().requires_grad_(True)
    y, counts = _counted(lambda: resnet.conv_bn(conv, nn.Identity(), xi))
    stem = name == "conv1"
    assert counts == {"unrolled": 0, "im2col": int(not stem), "cudnn": int(stem)}
    g = torch.randn(y.shape, generator=gen, dtype=dtype)
    dx, dw = torch.autograd.grad(y, (xi, conv.weight), g)
    want = _grads(conv, x, g, "conv2d")
    assert torch.equal(y, want[0])
    for a, b in ((dx, want[1]), (dw, want[2])):
        assert (a - b).abs().max().item() <= TOLERANCE[dtype] * b.abs().max().item()


def test_two_backward_passes_are_bit_equal():
    conv = _conv(16, 24, 3, 2, 1, True, torch.float32)
    x = torch.randn(5, 16, 7, 7)
    g = torch.randn(5, 24, 4, 4)
    first, second = (_grads(conv, x, g, "im2col") for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


class _MMDtypes(TorchDispatchMode):
    """Records the dtypes of every matrix product dispatched under it."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.dtypes.append(args[0].dtype)
        return func(*args, **(kwargs or {}))


def test_bfloat16_autocast_runs_the_gemms_in_bfloat16():
    """Under bfloat16 autocast the forward is the convolution's (bfloat16
    out), the backward's GEMMs run in bfloat16, as the convolution did, and
    the gradients come back in the input's and the parameters' float32,
    within bfloat16 rounding of the convolution's."""
    conv = _conv(8, 8, 3, 1, 1, True, torch.float32)
    x = torch.randn(4, 8, 5, 5)
    g = torch.randn(4, 8, 5, 5)
    grads = {}
    with torch.autocast("cpu", dtype=torch.bfloat16):
        for route in ("train", "conv"):
            xi = x.detach().requires_grad_(True)
            conv.zero_grad(set_to_none=True)
            y = resnet.conv_bn(conv, nn.Identity(), xi) if route == "train" else conv(xi)
            assert y.dtype == torch.bfloat16
            seen = _MMDtypes()
            with seen:
                (y.float() * g).sum().backward()
            if route == "train":
                assert seen.dtypes and set(seen.dtypes) == {torch.bfloat16}
            grads[route] = (y.detach(), xi.grad, conv.weight.grad, conv.bias.grad)
    assert torch.equal(grads["train"][0], grads["conv"][0])
    for a, b in zip(grads["train"][1:], grads["conv"][1:]):
        assert a.dtype == b.dtype == torch.float32
        assert (a - b).abs().max().item() <= 2 ** -6 * b.abs().max().item()


@pytest.mark.parametrize("change", [{"groups": 2}, {"dilation": 2}, {"padding_mode": "reflect"},
                                    {"padding": "same"}])
def test_the_rule_refuses_other_convolutions(change):
    conv = nn.Conv2d(4, 6, 3, **{"padding": 1, **change})
    assert not resnet.im2col_grad(conv, torch.zeros(1, 4, 5, 5, requires_grad=True))


def test_the_rule_wants_a_data_gradient_and_at_most_3x3():
    x = torch.zeros(1, 4, 9, 9, requires_grad=True)
    conv = nn.Conv2d(4, 6, 3, padding=1)
    assert not resnet.im2col_grad(conv, x.detach())
    assert resnet.im2col_grad(conv, x)
    assert resnet.im2col_grad(nn.Conv2d(4, 6, 1, stride=2), x)
    assert not resnet.im2col_grad(nn.Conv2d(4, 6, 5, padding=2), x)
    assert not resnet.im2col_grad(nn.Conv2d(4, 6, 7, stride=2, padding=3), x)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("pos_embed", [False, True])
def test_a_recorded_resnet10_forward_counts_5_6_2(train, pos_embed):
    """A ResNet-10 forward on 16 x 16 patches that autograd records: the five
    small maps take `SmallMapConv`, `layer1`, `layer2.conv1` and the three
    downsamples `Im2colGradConv`, and the stem's 7x7 and `fc0`, whose input
    wants no gradient, cuDNN's; its output is bit for bit the output with
    cuDNN's gradients on those six."""
    model = create_model(1, pos_embed, device="cpu").train(train)
    x = torch.randn(4, 2 if pos_embed else 1, 16, 16)
    got, counts = _counted(lambda: model(x))
    assert counts == {"unrolled": 5, "im2col": 6, "cudnn": 2}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnet, "im2col_grad", lambda conv, x: False)
        want, counts = _counted(lambda: model(x))
    assert counts == {"unrolled": 5, "im2col": 0, "cudnn": 8}
    assert torch.equal(got, want)


@pytest.mark.parametrize("how", ["train_no_grad", "fold", "fold_frozen_parameters",
                                 "train_frozen_parameters", "eval_bfloat16"])
def test_no_new_route_without_a_gradient(how):
    """Nothing that autograd does not record counts, and the output is bit
    for bit the one the routes without `Im2colGradConv` give: no_grad in
    train mode, the folded eval forward (under no_grad, or with parameters
    that want no gradient), train mode with such parameters and an input
    that wants none, and the plain bfloat16 eval forward."""
    dtype = torch.bfloat16 if how == "eval_bfloat16" else torch.float32
    model = create_model(1, True, device="cpu", seed=3, dtype=dtype).train(how.startswith("train"))
    x = torch.randn(3, 2, 16, 16)
    grad = how.endswith("frozen_parameters")
    for p in model.parameters():
        p.requires_grad_(not grad)

    def forward():
        with torch.set_grad_enabled(grad), resnet.frozen_statistics(model):
            return model(x)

    got, counts = _counted(forward)
    assert counts == {"unrolled": 0, "im2col": 0, "cudnn": 0}
    assert (model._fold is not None) == how.startswith("fold")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnet, "im2col_grad", lambda conv, x: False)
        want = forward()
    assert torch.equal(got, want)


def test_the_two_pass_stem_cnn_and_unet_add_nothing():
    """The float64 two-pass stem never reaches `conv_bn` (5 / 6 / 1), and
    the CNN and the UNet never call it."""
    model = create_model(1, False, device="cpu", fused_bn="twopass").train()
    _, counts = _counted(lambda: model(torch.randn(2, 1, 16, 16)))
    assert counts == {"unrolled": 5, "im2col": 6, "cudnn": 1}
    _, counts = _counted(lambda: (create_model(0, True, device="cpu").train()(
        torch.randn(2, 2, 16, 16)), UNet(1, 5)(torch.randn(1, 1, 32, 16))))
    assert counts == {"unrolled": 0, "im2col": 0, "cudnn": 0}


@pytest.mark.parametrize("fused_bn", [None, "twopass"])
def test_one_crw_step_matches_the_cudnn_gradient_step(fused_bn):
    """One `CRWTrainer.train_step` on the CPU (B 2, T 3, N 5) against the
    same step with cuDNN's gradients on the six convolutions: the loss
    equal (the forward is the same), and every leaf's gradient within
    float32 rounding (2e-6) of the larger of the leaf's largest magnitude
    and the median leaf's, as the benchmark's `grad_leaf_gap` scales it.
    The one-pass BatchNorm leaves `fc0`'s eps-sized gradient at float32's
    cancellation noise (models/encoders.py `ResNetEncoder._stem`): there
    `fc0` is left out; the two-pass BatchNorm's float64 stem holds it."""
    gen = torch.Generator().manual_seed(5)
    batch = torch.rand(2, 3, 5, 16, 16, generator=gen)
    runs = {}
    for route in ("im2col", "cudnn"):
        trainer = CRWTrainer(CRWTrainConfig(batch_size=2, seq_length=3, seed=5, fused_bn=fused_bn),
                             device="cpu")
        trainer.init_state(batch.shape[1:])
        with pytest.MonkeyPatch.context() as mp:
            if route == "cudnn":
                mp.setattr(resnet, "im2col_grad", lambda conv, x: False)
            loss, counts = _counted(lambda: trainer.train_step(batch))
        assert counts["im2col"] == (6 if route == "im2col" else 0)
        runs[route] = float(loss), {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    assert runs["im2col"][0] == runs["cudnn"][0]
    got, want = runs["im2col"][1], runs["cudnn"][1]
    assert got.keys() == want.keys()
    scales = {name: g.abs().max().item() for name, g in want.items()}
    median = statistics.median(scales.values())
    for name in want:
        if fused_bn is None and name.startswith("fc0."):
            continue
        err = (got[name] - want[name]).abs().max().item()
        assert err <= TOLERANCE[torch.float32] * max(scales[name], median), name
