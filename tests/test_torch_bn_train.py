"""The port's train-mode BatchNorm (radar_sounder_crw_tpu_torch/models/
resnet.py `BatchNorm`) vs flax `nn.BatchNorm` (momentum 0.9, eps 1e-5), as
the JAX package's `make_norm` builds it (CPU, float32).

Six train steps on offset inputs (|mean| >> std, where the one-pass
variance loses precision to float32 cancellation), for the one-pass default
and 'twopass': outputs, input gradients, running_mean and running_var
compared directly (flax blends the biased batch variance; no Bessel factor
anywhere). Tolerances, relative to each step's largest value, about 10x the
measured error: one-pass 1e-2 on outputs and input gradients (measured
1.2e-3: E[x^2] - E[x]^2 at mean 3 and std 0.05 keeps ~3 significant digits
of float32 and the two sides sum in different orders) and 5e-5 on
running_var (2.6e-6); two-pass 1e-4 on outputs and gradients (1.0e-5) and
2e-5 on running_var (0); running_mean 2e-6 both (6e-7). Eval mode is `nn.BatchNorm2d` exactly, and under
infer/propagate.py's `_batch_stats` the module normalizes with the batch's
statistics and leaves its buffers alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from radar_sounder_crw_tpu_torch.infer.propagate import _batch_stats
from radar_sounder_crw_tpu_torch.models.resnet import BatchNorm, frozen_statistics
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

C, K = 5, 6
TOL = {  # twopass: (outputs and gradients, running_var) rtol
    False: (1e-2, 5e-5),
    True: (1e-4, 2e-5),
}


def _inputs(seed=2, shape=(8, 6, 7, C), offset=3.0, std=0.05):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal(shape) * std + offset).astype(np.float32) for _ in range(K)]
    cots = [rng.standard_normal(shape).astype(np.float32) for _ in range(K)]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    return xs, cots, scale, bias


def _flax_steps(xs, cots, scale, bias, twopass):
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      use_fast_variance=not twopass)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = bn.init(jax.random.PRNGKey(0), xs[0])["batch_stats"]
    outs, grads, rms, rvs = [], [], [], []
    for x, cot in zip(xs, cots):
        def f(xx):
            y, upd = bn.apply({"params": params, "batch_stats": stats}, xx,
                              mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, upd["batch_stats"])

        (_, (y, stats)), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
        outs.append(np.asarray(y))
        grads.append(np.asarray(g))
        rms.append(np.asarray(stats["mean"]))
        rvs.append(np.asarray(stats["var"]))
    return outs, grads, rms, rvs


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _port_steps(xs, cots, scale, bias, twopass):
    bn = BatchNorm(C, twopass=twopass).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
    outs, grads, rms, rvs = [], [], [], []
    for x, cot in zip(xs, cots):
        xt = _nchw(x).requires_grad_(True)
        y = bn(xt)
        (y * _nchw(cot)).sum().backward()
        outs.append(_nhwc(y))
        grads.append(_nhwc(xt.grad))
        rms.append(bn.running_mean.numpy().copy())
        rvs.append(bn.running_var.numpy().copy())
    assert int(bn.num_batches_tracked) == K
    return outs, grads, rms, rvs


@pytest.mark.parametrize("twopass", [False, True])
def test_train_steps_match_flax(twopass):
    xs, cots, scale, bias = _inputs()
    want = _flax_steps(xs, cots, scale, bias, twopass)
    got = _port_steps(xs, cots, scale, bias, twopass)
    rtol, var_rtol = TOL[twopass]
    for k in range(K):
        y_scale = np.max(np.abs(want[0][k]))
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=0, atol=rtol * y_scale,
                                   err_msg=f"output, step {k}")
        g_scale = np.max(np.abs(want[1][k]))
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=0, atol=rtol * g_scale,
                                   err_msg=f"input gradient, step {k}")
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=2e-6, err_msg=f"mean, step {k}")
        np.testing.assert_allclose(got[3][k], want[3][k], rtol=var_rtol, err_msg=f"var, step {k}")


def test_running_var_blends_the_biased_variance():
    """The rule itself on exactly representable statistics: after one step
    from (0, 1) the buffers are 0.1 * mean and 0.9 + 0.1 * var_biased, where
    nn.BatchNorm2d would blend n/(n-1) * var."""
    x = torch.tensor([[1.0, 3.0], [5.0, 7.0]]).reshape(2, 1, 2, 1).repeat(1, 2, 1, 1)
    ours, theirs = BatchNorm(2).train(), torch.nn.BatchNorm2d(2).train()
    ours(x)
    theirs(x)
    n = 4
    var_biased = float(x[:, 0].var(unbiased=False))
    np.testing.assert_allclose(ours.running_mean.numpy(), [0.4, 0.4], rtol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(), [0.9 + 0.1 * var_biased] * 2, rtol=1e-6)
    np.testing.assert_allclose(theirs.running_var.numpy(),
                               [0.9 + 0.1 * var_biased * n / (n - 1)] * 2, rtol=1e-6)


def test_one_pass_variance_is_clamped_at_zero():
    """Channels at 1e3 with a spread far below float32's resolution there:
    E[x^2] - E[x]^2 rounds below 0 on some of them, and flax clamps it to 0,
    so the output and the statistics stay finite (no rsqrt of a negative)."""
    rng = np.random.default_rng(4)
    x = torch.tensor(1e3 + 1e-2 * rng.standard_normal((4, 16, 5, 5)), dtype=torch.float32)
    raw = x.square().mean(dim=(0, 2, 3)) - x.mean(dim=(0, 2, 3)).square()
    assert (raw < -1e-5).any()  # unclamped, rsqrt(var + eps) would be NaN
    bn = BatchNorm(16).train()
    y = bn(x)
    assert torch.isfinite(y).all()
    assert (bn.running_var >= 0.9).all() and torch.isfinite(bn.running_var).all()


def test_eval_mode_is_batchnorm2d():
    rng = np.random.default_rng(3)
    ours, theirs = BatchNorm(C).eval(), torch.nn.BatchNorm2d(C).eval()
    state = {
        "weight": torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.float32),
        "bias": torch.tensor(rng.standard_normal(C), dtype=torch.float32),
        "running_mean": torch.tensor(rng.standard_normal(C), dtype=torch.float32),
        "running_var": torch.tensor(rng.uniform(0.5, 2, C), dtype=torch.float32),
        "num_batches_tracked": torch.tensor(3),
    }
    ours.load_state_dict(state, strict=True)
    theirs.load_state_dict(state, strict=True)
    assert list(ours.state_dict()) == list(theirs.state_dict())
    x = torch.tensor(rng.standard_normal((4, C, 6, 6)), dtype=torch.float32)
    assert torch.equal(ours(x), theirs(x))
    y16 = ours(x.bfloat16())
    assert y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().detach().numpy(), theirs(x).detach().numpy(), atol=5e-2)


@pytest.mark.parametrize("context", ["batch_stats", "frozen"])
def test_batch_statistics_without_buffer_update(context):
    """`_batch_stats` (bn_train_mode inference) and `frozen_statistics` (the
    remat recompute): batch-statistics output equal to a plain train-mode
    call, buffers and the batch counter untouched."""
    xs, _, scale, bias = _inputs(offset=0.5, std=1.0)
    x = _nchw(xs[0])
    ref = BatchNorm(C).train()
    want = ref(x)
    model = torch.nn.Sequential(BatchNorm(C)).eval()
    if context == "frozen":
        model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ctx = _batch_stats(model) if context == "batch_stats" else frozen_statistics(model)
    with ctx:
        got = model(x)
    assert torch.equal(got, want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert model[0].training == (context == "frozen")
    assert model[0].track_running_stats
