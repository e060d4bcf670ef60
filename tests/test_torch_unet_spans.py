"""The UNet baseline's spans (`utils.profiling.span`) on the CPU: under
`torch.profiler` one `train_step(*gather(ids))` records `crw.unet.gather`,
`.forward`, `.loss`, `.backward` and `.optimizer` once each, in order, the
last four inside the step's root `crw.unet.step`, and `crw.unet.up` once
per decoder level inside the forward, around the
upsample (bilinear or the transposed convolution), pad and concat only;
with no profiler `span` is the one shared no-op; the step's loss and
parameters are bit-equal with the profiler on and off; and `gather` serves
the strips `make_resident` uploaded last, and nothing after soft labels."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radar_sounder_crw_tpu_torch.data import synthetic_radargram
from radar_sounder_crw_tpu_torch.models import UNet
from radar_sounder_crw_tpu_torch.train.unet_trainer import (
    UNetTrainConfig,
    UNetTrainer,
    unfold_strips,
)
from radar_sounder_crw_tpu_torch.utils import span
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

PHASES = ["crw.unet.gather", "crw.unet.forward", "crw.unet.loss", "crw.unet.backward",
          "crw.unet.optimizer"]


def _events(prof):
    """(name, start, end) of every `crw.*` host event, in start order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("crw.")), key=lambda e: e[1])


def _strips():
    rg, seg = synthetic_radargram(H=32, W=96, nclasses=5, seed=3)
    return unfold_strips(rg, seg, 16, 5)


def _trainer():
    """A seeded trainer with 6 strips of 32 x 16 resident."""
    x, y = _strips()
    t = UNetTrainer(UNetTrainConfig(patch_size=(32, 16), batch_size=2, lr=1e-3, seed=5),
                    device="cpu")
    t.init_state(x.shape)
    assert t.make_resident(x, y) is not None
    return t


def test_a_step_records_each_phase_once_and_up_per_level():
    t = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.train_step(*t.gather(np.array([4, 1])))
    ev = _events(prof)
    phases = [e for e in ev if e[0] not in ("crw.unet.up", "crw.unet.step")]
    assert [e[0] for e in phases] == PHASES
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:])), "phases overlap"
    (root,) = [e for e in ev if e[0] == "crw.unet.step"]
    assert all(root[1] <= s and e <= root[2] for _, s, e in phases[1:])
    forward = phases[1]
    ups = [e for e in ev if e[0] == "crw.unet.up"]
    assert len(ups) == 3
    assert all(forward[1] <= s and e <= forward[2] for _, s, e in ups)


@pytest.mark.parametrize("bilinear", [True, False])
def test_up_spans_hold_the_upsample_and_not_the_double_conv(bilinear):
    model = UNet(1, 5, bilinear=bilinear).eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(torch.randn(1, 1, 32, 16))
    names = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()]
    ups = [(s, e) for n, s, e in names if n == "crw.unet.up"]
    assert len(ups) == 3

    up_op = "aten::upsample_bilinear2d" if bilinear else "aten::conv_transpose2d"
    for a, b in ups:
        held = {n for n, s, e in names if a <= s and e <= b}
        assert {"aten::cat", "aten::pad", up_op} <= held
        # the DoubleConv's 3x3 convolutions and BatchNorms run after the span
        assert "aten::conv2d" not in held


def test_span_without_a_profiler_is_the_shared_no_op():
    assert span("crw.unet.up") is span("crw.unet.forward")


def _step(t, ids):
    loss = t.train_step(*t.gather(ids))
    return loss, {k: p.detach().clone() for k, p in t.model.named_parameters()}


def test_step_bit_equal_with_the_profiler_on_and_off():
    ids = np.array([0, 5])
    loss_off, params_off = _step(_trainer(), ids)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss_on, params_on = _step(_trainer(), ids)
    assert _events(prof), "the profiled step recorded no span"
    assert torch.equal(loss_on, loss_off)
    for k in params_off:
        assert torch.equal(params_on[k], params_off[k]), k


def test_gather_serves_the_strips_uploaded_last():
    t = _trainer()
    x, y = _strips()
    bx, by = t.gather(np.array([4, 1]))
    assert torch.equal(bx, torch.as_tensor(x[[4, 1]]).permute(0, 3, 1, 2))
    assert torch.equal(by, torch.as_tensor(y[[4, 1]]))
    assert t.make_resident(x, y * 0.5 + 0.1) is None  # soft labels: host batches
    with pytest.raises(ValueError, match="make_resident"):
        t.gather(np.array([0]))
