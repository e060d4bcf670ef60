"""The port of radar_sounder_crw_tpu/models/fused_bn.py (radar_sounder_crw_tpu_
torch/models/fused_bn.py: `FusedBatchNorm` on the kernels of csrc/bn_train.cu,
`LeanBatchNorm` on its statistics kernel) against the JAX modules, on the
CPU, where the kernels' plain twins run (ops/bn_cuda.py).

One layer, the same numpy inputs and parameters on both sides, at JAX's
own tolerances and losses (tests/test_fused_bn.py): in float32 the output
and the statistics within rtol 2e-6 / atol 2e-6, `fused`'s gradients under
a sum of squares within 1e-4, `lean`'s under their mean within 5e-6. In
bfloat16 the float32 values before the cast agree
as closely, so a cast can land one bfloat16 step apart: outputs within one
rounding (rtol 2**-7 / atol 2e-6), the statistics (float32) at 2e-6, the
parameter gradients (float32 sums of bfloat16 terms) within 1e-4 of their
largest magnitude, and the input gradients within JAX's bfloat16 tolerance
of 0.05 (of the largest magnitude) from the JAX float32 gradient, as JAX
holds its own bfloat16 module (`lean`'s input gradient adds bfloat16
cotangents in another grouping than XLA). `fused`'s variance is not
clamped: on channels of two values (sums that no order can change) the
port's variance equals JAX's bit for bit where it rounds below zero.
Two gloo ranks against one process, as tests/test_torch_parallel.py holds
them; a group of one rank bit-equal to no group. The encoders' gradients
against float64 are in tests/test_torch_fused_bn_encoder.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from radar_sounder_crw_tpu.models.fused_bn import FusedBatchNorm as JaxFused
from radar_sounder_crw_tpu.models.fused_bn import LeanBatchNorm as JaxLean
from radar_sounder_crw_tpu_torch.models import (
    BatchNorm,
    FusedBatchNorm,
    LeanBatchNorm,
    create_model,
    frozen_statistics,
    make_norm,
)
from radar_sounder_crw_tpu_torch.parallel import Mesh, make_mesh
import _torch_parallel_worker as worker
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)
from test_torch_parallel import _assert_equal_runs, _assert_stats_close, _spawn

JAX_MODULES = {"fused": JaxFused, "lean": JaxLean}
PORT_MODULES = {"fused": FusedBatchNorm, "lean": LeanBatchNorm}
GRAD_RTOL = {"fused": 1e-4, "lean": 5e-6}
# each variant's loss in tests/test_fused_bn.py: a sum of squares for
# `fused`, their mean for `lean`
REDUCE = {"fused": "sum", "lean": "mean"}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
C = 16


def _nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _layer_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 5, 5, C)).astype(np.float32)
    scale = (rng.standard_normal(C) + 1.0).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    tgt = rng.standard_normal(x.shape).astype(np.float32)
    return x, scale, bias, tgt


def _jax_layer(variant, jdtype, x, scale, bias, tgt):
    """(y, running mean, running var, d/dx, d/dscale, d/dbias) of one JAX
    step under the loss sum or mean of (y - tgt)^2."""
    mod = JAX_MODULES[variant](use_running_average=False, momentum=0.9, epsilon=1e-5,
                               dtype=jdtype)
    xj = jnp.asarray(x).astype(jdtype)
    stats = mod.init(jax.random.PRNGKey(0), xj)["batch_stats"]
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(p, xx):
        y, upd = mod.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        sq = (y.astype(jnp.float32) - tgt) ** 2
        return getattr(jnp, REDUCE[variant])(sq), (y, upd["batch_stats"])

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, xj)
    return [np.asarray(a, np.float32) for a in (y, upd["mean"], upd["var"], gx, gp["scale"],
                                                gp["bias"])]


def _port_layer(variant, tdtype, x, scale, bias, tgt):
    bn = PORT_MODULES[variant](C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
    xt = torch.as_tensor(_nchw(x)).to(tdtype).requires_grad_(True)
    y = bn(xt)
    assert y.dtype == tdtype
    sq = (y.float() - torch.as_tensor(_nchw(tgt))) ** 2
    getattr(sq, REDUCE[variant])().backward()
    return [_nhwc(y), bn.running_mean.numpy(), bn.running_var.numpy(), _nhwc(xt.grad),
            bn.weight.grad.numpy(), bn.bias.grad.numpy()]


def _close(got, want, rtol, atol, name):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["fused", "lean"])
def test_one_layer_matches_jax(variant, dtype):
    jdtype, tdtype = DTYPES[dtype]
    args = _layer_inputs()
    want = _jax_layer(variant, jdtype, *args)
    y, mean, var, gx, gscale, gbias = _port_layer(variant, tdtype, *args)
    _close(mean, want[1], 2e-6, 2e-6, "running mean")
    _close(var, want[2], 2e-6, 2e-6, "running var")
    if dtype == "float32":
        _close(y, want[0], 2e-6, 2e-6, "y")
        rtol = GRAD_RTOL[variant]
        for name, got, ref in (("dx", gx, want[3]), ("dscale", gscale, want[4]),
                               ("dbias", gbias, want[5])):
            _close(got, ref, rtol, rtol, name)
        return
    _close(y, want[0], 2**-7, 2e-6, "y")
    for name, got, ref in (("dscale", gscale, want[4]), ("dbias", gbias, want[5])):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=name)
    f32 = _jax_layer(variant, jnp.float32, *args)[3]
    for side, got in (("port", gx), ("jax", want[3])):
        np.testing.assert_allclose(got, f32, rtol=0, atol=0.05 * np.abs(f32).max(), err_msg=side)


def test_fused_variance_is_not_clamped():
    """Channels of two values at 1e3 whose spread is below float32's
    resolution there: E[x^2] - E[x]^2 rounds to -0.0625 on some. `fused`
    keeps it (rsqrt of a negative: NaN, as the JAX module gives), equal to
    JAX's bit for bit; flax's rule and `lean` clamp it to 0."""
    rng = np.random.default_rng(4)
    x = (1e3 + 1e-2 * rng.standard_normal((2, 1, 1, C))).astype(np.float32)
    scale, bias = np.ones(C, np.float32), np.zeros(C, np.float32)
    mod = JaxFused(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j, upd = mod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    var_j = (np.asarray(upd["batch_stats"]["var"]) - 0.9) / np.float32(0.1)

    from radar_sounder_crw_tpu_torch.models import bn_train

    y, mean, var = bn_train(torch.as_tensor(_nchw(x)), torch.as_tensor(scale),
                            torch.as_tensor(bias), 1e-5)
    assert (var.numpy() < 0).sum() >= 3
    running = FusedBatchNorm(C).train()
    running(torch.as_tensor(_nchw(x)))
    np.testing.assert_array_equal(running.running_var.numpy(), upd["batch_stats"]["var"])
    np.testing.assert_array_equal(running.running_mean.numpy(), upd["batch_stats"]["mean"])
    np.testing.assert_allclose(var.numpy(), var_j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(_nhwc(y)), np.isnan(np.asarray(y_j)))
    assert np.isnan(_nhwc(y)).any()
    for clamped in (BatchNorm(C).train(), LeanBatchNorm(C).train()):
        out = clamped(torch.as_tensor(_nchw(x)))
        assert torch.isfinite(out).all() and (clamped.running_var >= 0.9).all()


@pytest.mark.parametrize("variant", ["fused", "lean"])
def test_eval_and_frozen_statistics(variant):
    """Eval mode is `BatchNorm`'s (nn.BatchNorm2d) and matches the JAX
    module's running-average path; under `frozen_statistics` train mode
    leaves the buffers and the batch counter alone."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 4, 4, 8)).astype(np.float32)
    state = {"weight": rng.standard_normal(8), "bias": rng.standard_normal(8),
             "running_mean": rng.standard_normal(8), "running_var": np.abs(
                 rng.standard_normal(8)) + 0.5}
    state = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in state.items()}
    state["num_batches_tracked"] = torch.tensor(3)
    bn, plain = make_norm(variant, 8).eval(), BatchNorm(8).eval()
    bn.load_state_dict(state, strict=True)
    plain.load_state_dict(state, strict=True)
    xt = torch.as_tensor(_nchw(x))
    assert torch.equal(bn(xt), plain(xt))
    v = {"params": {"scale": state["weight"].numpy(), "bias": state["bias"].numpy()},
         "batch_stats": {"mean": state["running_mean"].numpy(),
                         "var": state["running_var"].numpy()}}
    want = JAX_MODULES[variant](use_running_average=True, epsilon=1e-5).apply(v, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(bn(xt)), np.asarray(want), rtol=1e-6, atol=1e-6)
    bn.train()
    before = {k: t.clone() for k, t in bn.state_dict().items()}
    with frozen_statistics(bn):
        y = bn(xt)
    assert torch.isfinite(y).all()
    for k, t in bn.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_make_norm_takes_every_jax_value():
    """create_model(1, fused_bn=v) builds the module JAX's make_norm picks
    for every value it accepts, with the same state-dict keys; an unknown
    value raises as JAX's does; the CNN has no BatchNorm and ignores it."""
    kinds = {None: BatchNorm, False: BatchNorm, "twopass": BatchNorm, True: FusedBatchNorm,
             "fused": FusedBatchNorm, "lean": LeanBatchNorm}
    keys = list(create_model(1, False, device="cpu").state_dict())
    for value, kind in kinds.items():
        model = create_model(1, False, device="cpu", fused_bn=value)
        bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
        assert len(bns) == 13 and all(type(m) is kind for m in bns), value
        assert all(m.twopass == (value == "twopass") for m in bns)
        assert list(model.state_dict()) == keys
    with pytest.raises(ValueError, match="unknown BatchNorm implementation"):
        create_model(1, False, device="cpu", fused_bn="bogus")
    assert create_model(0, False, device="cpu", fused_bn="fused") is not None


def test_two_ranks_equal_one_process(tmp_path):
    """fused_bn 'fused' and 'lean' over two gloo ranks against one process:
    a sharded ResNet step's loss within rtol 1e-5 and its running
    statistics within rtol 1e-5 / atol 1e-6 (the one-pass variance's
    rule), a whole batch exactly, one BatchNorm's output, gradients and
    running statistics within rtol 1e-5 / atol 1e-6."""
    inits = {"resnet": create_model(1, False, device="cpu", seed=3).state_dict()}
    torch.save(inits, tmp_path / "inits.pt")
    _spawn(worker.rank_main, (2, str(tmp_path / "init"), str(tmp_path), "fused_bn_checks"), 2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    one = worker.fused_bn_checks(make_mesh(["cpu"]), inits)
    two = ranks[0]
    for variant in ("fused", "lean"):
        sharded = f"resnet_{variant}_sharded"
        _assert_equal_runs(ranks[1][sharded], two[sharded])
        np.testing.assert_allclose(two[sharded]["losses"], one[sharded]["losses"], rtol=1e-5)
        _assert_stats_close(two[sharded]["state"], one[sharded]["state"], 1e-6)
        _assert_equal_runs(two[f"resnet_{variant}_whole"], one[f"resnet_{variant}_whole"])
        for r, rank in enumerate(ranks):
            got, want = rank["bn"][variant], one["bn"][variant]
            rows = slice(4 * r, 4 * r + 4)
            for k in got:
                full = k in ("y", "x_grad")
                np.testing.assert_allclose(got[k].numpy(), want[k][rows].numpy() if full
                                           else want[k].numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k} {variant}")


def test_a_group_of_one_rank_is_the_local_rule(tmp_path):
    """Under a gloo group of one rank the sharded step issues every
    collective of 'fused' and 'lean'; they are the identity, so the step
    equals the mesh-free one bit for bit."""
    inits = {"resnet": create_model(1, False, device="cpu", seed=3).state_dict()}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        group = make_mesh()
        assert group.group is not None
        for variant in ("fused", "lean"):
            _assert_equal_runs(
                worker.crw_run(group, 1, inits["resnet"], (worker.SHARDED,), fused_bn=variant),
                worker.crw_run(Mesh(torch.device("cpu")), 1, inits["resnet"],
                               (worker.SHARDED,), fused_bn=variant))
    finally:
        dist.destroy_process_group()
