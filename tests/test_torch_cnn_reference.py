"""The port's CNN encoder (model id 0: models/encoders.py `CNNEncoder`) and
its CRW training step (`CRWTrainer(model=0)`) against the benchmark's plain
reference (portbench/reference/cnn.py), on the CPU in float32 from seeded
weights (portbench/cnn_weights.py) loaded with strict=True, at B 2, T 5,
N 6 and 16 x 16 patches.

Tolerances, each from float32 with the same operations in another order:
the embeddings within 1e-6 of their largest magnitude (the same convolutions,
pools and head on the same weights; measured 0); each step's loss within a
relative 1e-6 (the port's O(T) palindrome walk and per-item mean against
the reference's walk rebuilt at each depth and one mean; measured 3.2e-7
on the test's weights, 1.7e-7 and 3.4e-7 on two other seeds); each leaf's
first gradient (Adam's first moment / 0.1 after step 1) within a relative
1e-5 of the leaf's norm (measured 2.8e-6, 2.4e-6, 1.2e-6); each leaf's
change after 3 steps within a relative 5e-3 of its norm (measured 1.4e-5,
and 1.05e-3 and 6.5e-4 on the other seeds, in `conv3`: the CNN has
channels that ReLU leaves nearly dead, whose gradient entries sit near the
rounding level, and Adam's step, m / sqrt(v), lifts such an entry's
rounding to a share of lr whatever its size).
A planted fault (pools of stride 2, or padding 0 on a 5x5 convolution)
fails them.
"""

import pytest
import torch
from torch import nn

from portbench import cnn_weights, synth
from portbench.reference import cnn as ref_cnn
from portbench.reference import crw as ref_crw
from portbench.reference import propagate as ref_prop
from radar_sounder_crw_tpu_torch.models import create_model
from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer
from radar_sounder_crw_tpu_torch.utils import maybe_pos_embed
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

B, T, N, P, STEPS, LR, TAU = 2, 5, 6, 16, 3, 1e-3, 0.01
EMB_TOL, LOSS_TOL, GRAD_TOL, CHANGE_TOL = 1e-6, 1e-6, 1e-5, 5e-3


@pytest.fixture(scope="module")
def batches():
    """Three batches (B, T, N, 16, 16) of windows of a synthetic SHARAD-like
    radargram, 8 px row overlap."""
    rows = (N + 1) * (P // 2)
    rg, _ = synth.radargram(rows, T * P * B * STEPS, 5, 31, "cpu")
    starts = [i * T * P for i in range(B * STEPS)]
    out = ref_prop.windows(rg, starts, T, N, (P, P), (P // 2, 0))
    return [out[i * B:(i + 1) * B] for i in range(STEPS)]


def _model(sd, pos_embed):
    model = create_model(0, pos_embed, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def _trainer(sd):
    t = CRWTrainer(CRWTrainConfig(model=0, batch_size=B, seq_length=T, lr=LR, tau=TAU),
                   device="cpu")
    t.init_state((T, N, P, P))
    t.model.load_state_dict(sd, strict=True)
    return t


def _program(sd, batches, fault=None):
    """(losses, first gradients, parameters after the steps) of the port."""
    t = _trainer(sd)
    if fault is not None:
        fault(t.model)
    losses, grad1 = [], None
    for i, batch in enumerate(batches):
        losses.append(float(t.train_step(batch)))
        if i == 0:
            grad1 = {k: t.optimizer.state[p]["exp_avg"] / 0.1
                     for k, p in t.model.named_parameters()}
    return losses, grad1, {k: p.detach().clone() for k, p in t.model.named_parameters()}


def _reference(sd, batches):
    params = {k: v.clone() for k, v in sd.items()}
    trainable = list(params)
    opt = ref_crw.Adam({k: params[k] for k in trainable}, lr=LR)
    losses, grad1 = [], None
    for i, batch in enumerate(batches):
        loss, grads = ref_cnn.train_step(params, trainable, opt, batch, TAU)
        losses.append(loss)
        grad1 = grads if i == 0 else grad1
    return losses, grad1, {k: params[k] for k in trainable}


def _gaps(prog, ref, sd):
    """{'loss': worst relative loss gap, 'grad1': worst first-gradient leaf
    gap, 'change': worst change leaf gap}, a leaf's gap the norm of its
    difference over its reference's."""
    (pl, pg, pa), (rl, rg, ra) = prog, ref

    def leaf(p, r):
        return max(float((p[k] - r[k]).norm() / r[k].norm().clamp_min(1e-30)) for k in r)

    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(pl, rl)),
            "grad1": leaf(pg, rg),
            "change": leaf({k: pa[k] - sd[k] for k in ra}, {k: ra[k] - sd[k] for k in ra})}


TOL = {"loss": LOSS_TOL, "grad1": GRAD_TOL, "change": CHANGE_TOL}


@pytest.fixture(scope="module")
def step_gaps(batches):
    sd = cnn_weights.state_dict(23, "cpu")
    return _gaps(_program(sd, batches), _reference(sd, batches), sd)


def _emb_gap(model, sd, x) -> float:
    with torch.no_grad():
        got = model(x)
        want = ref_cnn.encode(sd, x)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], 128)
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("pos_embed", [False, True], ids=["one_channel", "pos_embed"])
def test_parameters_are_the_references(pos_embed):
    in_ch = 2 if pos_embed else 1
    model = _model(cnn_weights.state_dict(0, "cpu", in_ch), pos_embed)
    got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert got == [(k, tuple(s)) for k, s, _ in ref_cnn.parameter_shapes(in_ch)]
    assert sum(v.numel() for v in model.state_dict().values()) == (263_088 + 200 * pos_embed)


@pytest.mark.parametrize("pos_embed", [False, True], ids=["one_channel", "pos_embed"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_embeddings_match_the_reference(batches, train, pos_embed):
    sd = cnn_weights.state_dict(5, "cpu", 2 if pos_embed else 1)
    x = maybe_pos_embed(batches[0].reshape(B * T * N, 1, P, P), pos_embed)
    assert x.shape[1] == (2 if pos_embed else 1)
    assert _emb_gap(_model(sd, pos_embed).train(train), sd, x) <= EMB_TOL


@pytest.mark.parametrize("number", ["loss", "grad1", "change"])
def test_three_steps_match_the_reference(step_gaps, number):
    assert step_gaps[number] <= TOL[number], step_gaps


def _pool_stride_2(model):
    model.pool = nn.MaxPool2d(2, stride=2)


def _conv1_padding_0(model):
    model.conv1.padding = (0, 0)


@pytest.mark.parametrize("fault", [_pool_stride_2, _conv1_padding_0],
                         ids=["pool_stride_2", "conv1_padding_0"])
def test_a_planted_fault_fails(batches, fault):
    sd = cnn_weights.state_dict(23, "cpu")
    model = _model(sd, False)
    fault(model)
    x = batches[0].reshape(B * T * N, 1, P, P)
    assert _emb_gap(model, sd, x) > 100 * EMB_TOL
    gaps = _gaps(_program(sd, batches, fault), _reference(sd, batches), sd)
    assert all(gaps[k] > TOL[k] for k in TOL), gaps
