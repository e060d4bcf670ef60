"""The CNN encoder (model id 0) on the survey path: the port's
`PropagationPipeline(create_model(0)).propagate_survey` over a toy line
(4 radargrams, 104 rows, T 16, N 12, 6 classes), forward with change
detection, one correction group and the reverse pass (`use_last`), then the
port's host assembly, against the benchmark's plain reference on the CPU in
float32 from seeded weights (portbench/cnn_weights.py) loaded with
strict=True: the CNN's embeddings of reference/cnn_infer.py, the
propagation, xent and change signal of reference/propagate.py, PELT of
reference/pelt.py and the assembly of reference/survey.py. PELT's
breakpoints fall on multiples of 5 and the change point is the last but one
plus 5, so a correction (a change point below T - 1) needs T of 12 or more;
at T 16 the cell's penalty of 5 finds no change in the 14-point signals, so
the test takes 1, at which this line has two corrections of one length.

Tolerances: every class of the forward, correction and reverse maps is the
reference's best soft label (the benchmark's map-agreement rule, at most
1e-5 of the entries, which at this size is none: the two sides run the same
convolutions, pools and head on the same weights, and the propagation's
products in float32 differ only in their order); the change points equal
(PELT's choice is discrete, and the signals differ by float32 rounding);
the assembled pixel map equal (integer maps through nearest resizes,
splices, the flip and the merge). Pools of stride 2, or the reverse pass
seeded from the unflipped segmentation, fail them. Beside it, the
`encoders.patches` counter: each encoder kind counts its own patches.
"""

import numpy as np
import pytest
import torch

from portbench import cnn_weights, synth
from portbench.reference import cnn_infer
from portbench.reference import pelt as ref_pelt
from portbench.reference import propagate as ref
from portbench.reference import survey as ref_survey
from radar_sounder_crw_tpu_torch.data.radargram import RGWindows
from radar_sounder_crw_tpu_torch.infer import (
    PropagationPipeline,
    correction_pixel_offset,
    integrate_flat_mcords3,
    reverse_unfold_flip,
    splice_correction,
)
from radar_sounder_crw_tpu_torch.models import create_model, encoders
from radar_sounder_crw_tpu_torch.ops import LabelPropConfig
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

R, H, T, N, P, OH, M = 4, 104, 16, 12, 16, 8, 6
PROP = dict(cxt=4, radius=10, temperature=0.1, knn=20)
XENT_TAU, PELT_PEN, SEED = 0.1, 1.0, 2 ** 33 + 2
RG_LEN = T * P
CLASS_TOL = 1e-5


@pytest.fixture(scope="module")
def line():
    rg, seg = synth.radargram(H, R * RG_LEN, M, SEED, "cpu")
    return rg.numpy(), seg.to(torch.int32).numpy(), cnn_weights.state_dict(SEED, "cpu")


def _refs(seg):
    return [seg[:, RG_LEN * t: RG_LEN * t + P] for t in range(R)]


def _port(line, fault=None):
    """The port's passes over the line, as the batch evaluation runs them,
    and its assembled map."""
    rg, seg, sd = line
    model = create_model(0, False, device="cpu")
    model.load_state_dict(sd, strict=True)
    if fault == "stride2":
        model.pool = torch.nn.MaxPool2d(2, stride=2)
    pipe = PropagationPipeline(
        model, LabelPropConfig(PROP["cxt"], PROP["radius"], PROP["temperature"], PROP["knn"]),
        M, xent_tau=XENT_TAU, pelt_pen=PELT_PEN, device="cpu")
    ds = RGWindows(rg, length=T, dim=(P, P), overlap=(OH, 0))
    ids = list(range(0, R * T, T))
    fwd, change = pipe.propagate_survey(ds, ids, _refs(seg), detect_change=True)
    corrected = {}
    due = ref_survey.corrections(change, T, P, 0)
    small = due[0][2] if due else None
    group = [(t, off) for t, off, s in due if s == small]  # one correction group
    if group:
        preds = pipe.propagate_survey(
            ds, [ids[t] for t, _ in group],
            [seg[:, RG_LEN * t + RG_LEN - off: RG_LEN * t + RG_LEN - off + P] for t, off in group],
            length=small, frame_offsets=[0] * len(group))
        corrected = {(small, t): p for (t, _), p in zip(group, preds)}
    seg_rev = seg if fault == "unflipped" else ref_survey.flip_blocks(seg, RG_LEN)
    rev = pipe.propagate_survey(ds, ids, _refs(seg_rev), use_last=True)
    px = [pipe.prediction_to_pixels(f, (H, RG_LEN)) for f in fwd]
    for (s, t), pred in corrected.items():
        px[t] = splice_correction(px[t], pred, correction_pixel_offset(s, P, 0))
    rev_px = [pipe.prediction_to_pixels(r, (H, RG_LEN)) for r in rev]
    final = integrate_flat_mcords3(np.concatenate(px, axis=1).ravel(), reverse_unfold_flip(
        np.concatenate(rev_px, axis=1), RG_LEN))
    return fwd, change, corrected, rev, final


def _soft(emb, seg_cols):
    seeds = torch.as_tensor(np.stack([ref.seed_labels(s, N) for s in seg_cols]))
    return ref.propagate(emb, seeds, M, **PROP)


def _judge(line, out):
    """(share of map entries off the reference's best class, change points
    unlike the reference's, pixels unlike the reference's assembly)."""
    rg, seg, sd = line
    fwd, change, corrected, rev, final = out
    wins = ref.windows(torch.as_tensor(rg), [RG_LEN * t for t in range(R)], T, N, (P, P),
                       (OH, 0))
    emb = cnn_infer.embed(sd, wins)
    dis = [ref.disagreements(_soft(emb, _refs(seg)), torch.as_tensor(fwd).transpose(1, 2))]
    for (s, t), pred in corrected.items():
        c0 = RG_LEN * t + RG_LEN - s * P
        dis.append(ref.disagreements(_soft(emb[t:t + 1, :s], [seg[:, c0:c0 + P]]),
                                     torch.as_tensor(pred).T[None]))
    seg_rev = ref_survey.flip_blocks(seg, RG_LEN)
    dis.append(ref.disagreements(_soft(emb.flip(1), _refs(seg_rev)),
                                 torch.as_tensor(rev).transpose(1, 2)))
    sig = ref.change_signal(ref.xent_map(emb, XENT_TAU)).numpy()
    want = [ref_pelt.detect_change_point(s, pen=PELT_PEN) for s in sig]
    assembled = ref_survey.assemble(fwd, change, corrected, rev, H, T, P, 0, "mcords3_flat")
    share = sum(d for d, _ in dis) / sum(n for _, n in dis)
    return share, sum(a != b for a, b in zip(want, change)), int((assembled != final).sum())


def test_cnn_survey_matches_reference(line):
    out = _port(line)
    assert len(out[2]) == 2, "the toy line has a correction group of two radargrams"
    share, changes, pixels = _judge(line, out)
    assert share <= CLASS_TOL
    assert changes == 0
    assert pixels == 0


@pytest.mark.parametrize("fault", ["stride2", "unflipped"])
def test_planted_fault_fails(line, fault):
    share, changes, pixels = _judge(line, _port(line, fault))
    assert share > CLASS_TOL or changes > 0 or pixels > 0


def test_patches_counter_counts_each_kind():
    """The CNN and the ResNet each add the patches of their forwards, in
    eval and in training, under their own key."""
    cnn, resnet = create_model(0, False, device="cpu"), create_model(1, False, device="cpu")
    x = torch.randn(5, 1, P, P)
    before = dict(encoders.patches)
    with torch.no_grad():
        cnn(x)
        resnet(x[:3])
    cnn.train()(x[:2]).sum().backward()
    assert encoders.patches["cnn"] - before["cnn"] == 7
    assert encoders.patches["resnet"] - before["resnet"] == 3
