"""Entry: the supervised UNet baseline's training as `cli.test_unet` runs it:
SHARAD radargrams unfolded into full-height strips (`unfold_strips`), a
seeded 90/10 split (`train_test_split`), `UNetTrainer` (Adam, train-mode
BatchNorm, the job's double-softmax cross-entropy) on the training strips
uploaded once (`make_resident`), each step `train_step` on a batch that
`gather` builds on the device, as `UNetTrainer.fit` stages it. One request
is one optimizer step on a full batch; batches are consecutive full batches
of per-epoch permutations drawn from the seed (the partial batch is not
drawn). The host runs ahead of the device as in `fit`, and the window
closes once the device has finished the last step queued.

Set-up builds the trainer, loads the benchmark's weights
(portbench/unet_weights.py) and drives it through the first `checked_steps`
steps of the same feed; the check runs the reference (reference/unet.py)
from the same weights over the same strips, cut from the radargrams
directly, and compares as entries/train.py does: each step's loss, the
first gradient as Adam holds it (its first moment over 1 - beta1) and the
parameters' change after those steps, leaf by leaf.

Mix keys: radargrams, checked_steps, trace_seconds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench import synth, unet_arith, unet_weights
from portbench.entries import common
from portbench.entries import train as crw_train
from portbench.reference import crw as ref_crw
from portbench.reference import unet as ref_unet
from portbench.trace import span

BETA1 = 0.9  # torch.optim.Adam's default, which the trainer uses


def setup(ctx):
    from radar_sounder_crw_tpu_torch.train.unet_trainer import (
        UNetTrainConfig,
        UNetTrainer,
        train_test_split,
        unfold_strips,
    )

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    if cfg["model"] != "unet" or not cfg["bilinear"] or cfg["optimizer"] != "adam" \
            or cfg["dtype"] != "float32" or cfg["tf32"]:
        raise ValueError("this entry runs the float32 bilinear UNet with Adam, TF32 off")
    (H, w), B, M = cfg["strip"], cfg["batch_size"], cfg["n_classes"]
    if H != cfg["rows"]:
        raise ValueError("the strips are full height")
    n = mix["radargrams"]
    seeds = common.child_seeds(ctx.seed, 3 + n)
    rgs, segs = [], []
    for k in range(n):
        rg, seg = synth.radargram(cfg["rows"], cfg["width"], M, seeds[1 + k], dev)
        rgs.append(rg.cpu().numpy())
        segs.append(seg.cpu().numpy())
        del rg, seg
    strips = [unfold_strips(r, s, w, M) for r, s in zip(rgs, segs)]
    x = np.concatenate([a for a, _ in strips])
    y = np.concatenate([b for _, b in strips])
    del strips
    train_ids, _ = train_test_split(len(x), cfg["split"], seeds[1 + n])
    sd = unet_weights.state_dict(seeds[0], dev, cfg["n_channels"], M)
    trainer = UNetTrainer(UNetTrainConfig(
        patch_size=(H, w), split=cfg["split"], batch_size=B, lr=cfg["lr"], n_classes=M,
        quirk_double_softmax=cfg["quirk_double_softmax"], dtype=torch.float32,
        device_resident=True), device=dev)
    x_train, y_train = x[train_ids], y[train_ids]
    del x, y
    trainer.init_state(x_train.shape)
    trainer.model.load_state_dict(sd, strict=True)
    trainer.make_resident(x_train, y_train)
    # n_windows: the training strips, which crw_train._batch_ids permutes
    state = common.State(config=cfg, mix=mix, device=dev, seed=ctx.seed, sd=sd,
                         trainer=trainer, rgs=rgs, segs=segs, strip_ids=train_ids,
                         n_windows=len(train_ids), order=[], B=B,
                         rng=np.random.default_rng(seeds[-1]))
    state.flops = unet_arith.train_step_flops(B, H, w, cfg["n_channels"], M)
    names = {p: k for k, p in trainer.model.named_parameters()}
    state.losses, state.grad1 = [], None
    for i in range(mix["checked_steps"]):
        state.losses.append(request(state, i, keep_loss=True))
        if i == 0:
            opt = trainer.optimizer
            # an optimizer that holds no moment for a leaf holds no gradient of it
            state.grad1 = {names[p]: opt.state[p]["exp_avg"].detach() / (1 - BETA1)
                           if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                           for p in trainer.model.parameters()}
    state.after = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    state.losses = [float(v) for v in state.losses]
    state.log.clear()
    return state


def request(state, i, keep_loss=False):
    ids = crw_train._batch_ids(state, i)
    with span("unet_train.gather"):
        x, onehot = state.trainer.gather(ids)
    with span("unet_train.step"):
        loss = state.trainer.train_step(x, onehot)
    state.log.append({"flops": state.flops})
    return loss if keep_loss else 1


def finish(state):
    common.synchronize(state.device)


def counters(state):
    return {}


def _strips(state, ids):
    """The reference's batch of training strips `ids`, cut from the
    radargrams: (x (B, 1, H, w), one-hot (B, H, w, M)) on the device."""
    w = state.config["strip"][1]
    per = state.config["width"] // w
    cut = [(int(g) // per, (int(g) % per) * w) for g in state.strip_ids[ids]]
    x = np.stack([state.rgs[k][:, c:c + w] for k, c in cut])[:, None]
    labels = np.stack([state.segs[k][:, c:c + w] for k, c in cut])
    labels = torch.as_tensor(labels, device=state.device)
    return (torch.as_tensor(x, device=state.device),
            F.one_hot(labels, state.config["n_classes"]).float())


def _reference(state, n_steps, precise=True, half_batch=False, quirk=None):
    """(losses, first gradients, parameters after n_steps) of the reference
    from the benchmark's weights over the feed's first n_steps batches."""
    cfg = state.config
    quirk = cfg["quirk_double_softmax"] if quirk is None else quirk
    params = {k: v.detach().clone().float() for k, v in state.sd.items()}
    trainable = [k for k in params if not k.split(".")[-1].startswith(("running_", "num_"))]
    opt = ref_crw.Adam({k: params[k] for k in trainable}, lr=cfg["lr"])
    losses, grad1 = [], None
    with common.tf32(not precise):
        for i in range(n_steps):
            ids = state.order[i]
            if half_batch:
                ids = ids[: len(ids) // 2]
            x, onehot = _strips(state, ids)
            loss, grads = ref_unet.train_step(params, trainable, opt, x, onehot, quirk)
            losses.append(loss)
            if i == 0:
                grad1 = {k: g.detach() for k, g in grads.items()}
            del x, onehot, grads
    return losses, grad1, {k: params[k] for k in trainable}


def check(state, limits):
    n = state.mix["checked_steps"]
    prog = (state.losses, state.grad1, state.after)
    common.release(state, "trainer")
    return crw_train._numbers(state, prog, _reference(state, n), limits)


def control(state, limits, n: int = 0, fault: str = "tf32"):
    """In the program's place: the reference in TF32 ('tf32'), or in float32
    on half of each batch, the mean taken over the rest ('half_batch'), or
    with the standard cross-entropy in place of the job's ('quirk_off'),
    judged by the full reference."""
    steps = state.mix["checked_steps"]
    common.release(state, "trainer")
    lo = _reference(state, steps, precise=fault != "tf32", half_batch=fault == "half_batch",
                    quirk=False if fault == "quirk_off" else None)
    return crw_train._numbers(state, lo, _reference(state, steps), limits)
