"""The port's UNet baseline (models/unet.py, train/unet_trainer.py) against
the benchmark's plain reference (portbench/reference/unet.py), on the CPU
in float32 from seeded weights (portbench/unet_weights.py) loaded with
strict=True, at B 2 of 32 x 16 strips and 5 classes.

Tolerances, each from float32 with the same operations in another order
(the port's per-item loss means against the reference's one mean over all
pixels; its BatchNorm and softmax written apart from the reference's):
logits within 1e-5 of their largest magnitude (measured 7e-7 in eval mode,
0 in train mode); each step's loss within a relative 1e-6 (measured
1.4e-7); each leaf's first gradient (Adam's first moment / 0.1 after step
1) within a relative 1e-5 of the leaf's norm (measured 3.5e-8); each leaf's
change after 3 steps within a relative 1e-3 of its norm (measured 1.1e-5:
Adam moves an entry by ~lr whatever its gradient's size, so an entry whose
gradient is at the rounding level can move by up to 2 lr more on one side;
the worst leaf holds 4 such entries of 589,824). A planted fault
(upsampling without aligned corners, the standard cross-entropy where the
job soft-maxes twice) fails them.
"""

import pytest
import torch
import torch.nn.functional as F

from portbench import synth, unet_weights
from portbench.reference import crw as ref_crw
from portbench.reference import unet as ref_unet
from radar_sounder_crw_tpu_torch.train.unet_trainer import UNetTrainConfig, UNetTrainer
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

B, H, W, M, LR, STEPS = 2, 32, 16, 5, 1e-3, 3
LOGIT_TOL, LOSS_TOL, GRAD_TOL, CHANGE_TOL = 1e-5, 1e-6, 1e-5, 1e-3


@pytest.fixture(scope="module")
def data():
    """Three batches (x (B, 1, H, W), one-hot (B, H, W, M)) of synthetic
    strips and the weights."""
    rg, seg = synth.radargram(H, W * B * STEPS, M, 17, "cpu")
    x = rg.reshape(H, B * STEPS, W).permute(1, 0, 2)[:, None].contiguous()
    y = F.one_hot(seg.reshape(H, B * STEPS, W).permute(1, 0, 2), M).float()
    batches = [(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B]) for i in range(STEPS)]
    return batches, unet_weights.state_dict(23, "cpu", 1, M)


def _trainer(sd, quirk=True):
    t = UNetTrainer(UNetTrainConfig(patch_size=(H, W), batch_size=B, lr=LR, n_classes=M,
                                    quirk_double_softmax=quirk), device="cpu")
    t.init_state((B, H, W, 1))
    t.model.load_state_dict(sd, strict=True)
    return t


def _program(sd, batches, quirk):
    """(losses, first gradients, parameters after the steps) of the port."""
    t = _trainer(sd, quirk)
    losses, grad1 = [], None
    for i, (x, y) in enumerate(batches):
        losses.append(float(t.train_step(x, y)))
        if i == 0:
            grad1 = {k: t.optimizer.state[p]["exp_avg"] / 0.1
                     for k, p in t.model.named_parameters()}
    return losses, grad1, {k: p.detach().clone() for k, p in t.model.named_parameters()}


def _reference(sd, batches, quirk):
    params = {k: v.clone() for k, v in sd.items()}
    trainable = [k for k, _ in _trainer(sd).model.named_parameters()]
    opt = ref_crw.Adam({k: params[k] for k in trainable}, lr=LR)
    losses, grad1 = [], None
    for i, (x, y) in enumerate(batches):
        loss, grads = ref_unet.train_step(params, trainable, opt, x, y, quirk)
        losses.append(loss)
        grad1 = grads if i == 0 else grad1
    return losses, grad1, {k: params[k] for k in trainable}


def _gaps(prog, ref, sd):
    """(worst relative loss gap, worst first-gradient leaf gap, worst change
    leaf gap), a leaf's gap the norm of its difference over its reference's."""
    (pl, pg, pa), (rl, rg, ra) = prog, ref

    def leaf(p, r):
        return max(float((p[k] - r[k]).norm() / r[k].norm().clamp_min(1e-30)) for k in r)

    loss = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    change = leaf({k: pa[k] - sd[k] for k in ra}, {k: ra[k] - sd[k] for k in ra})
    return loss, leaf(pg, rg), change


def test_parameters_are_the_references():
    sd = unet_weights.state_dict(0, "cpu", 1, M)
    model = _trainer(sd).model
    got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert got == [(k, tuple(s)) for k, s, _ in ref_unet.parameter_shapes(1, M)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_logits_match_the_reference(data, train):
    batches, sd = data
    x = batches[0][0]
    model = _trainer(sd).model.train(train)
    with torch.no_grad():
        got = model(x)
        want = ref_unet.forward(sd, x, train=train)
    assert got.dtype == torch.float32 and got.shape == (B, M, H, W)
    assert float((got - want).abs().max()) <= LOGIT_TOL * float(want.abs().max())


@pytest.mark.parametrize("quirk", [True, False], ids=["double_softmax", "plain_ce"])
def test_three_steps_match_the_reference(data, quirk):
    batches, sd = data
    loss, grad, change = _gaps(_program(sd, batches, quirk), _reference(sd, batches, quirk), sd)
    assert loss <= LOSS_TOL and grad <= GRAD_TOL and change <= CHANGE_TOL, (loss, grad, change)


def test_quirk_changes_the_reference_loss(data):
    batches, sd = data
    logits = ref_unet.forward(sd, batches[0][0], train=True)
    on, off = (float(ref_unet.loss(logits, batches[0][1], q)) for q in (True, False))
    assert abs(on - off) > 100 * LOSS_TOL * abs(off)


@pytest.mark.parametrize("fault", ["align_corners_false", "plain_ce_in_the_program"])
def test_a_planted_fault_fails(data, monkeypatch, fault):
    batches, sd = data
    quirk = True
    if fault == "align_corners_false":
        def misaligned(x, out_hw):
            return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)

        monkeypatch.setattr("radar_sounder_crw_tpu_torch.models.unet."
                            "resize_bilinear_align_corners", misaligned)
        x = batches[0][0]
        with torch.no_grad():
            got = _trainer(sd).model.train()(x)
        want = ref_unet.forward(sd, x, train=True)
        assert float((got - want).abs().max()) > LOGIT_TOL * float(want.abs().max())
    else:
        prog = _program(sd, batches, quirk=False)
        loss, grad, change = _gaps(prog, _reference(sd, batches, quirk), sd)
        assert loss > LOSS_TOL and grad > GRAD_TOL and change > CHANGE_TOL, (loss, grad, change)
