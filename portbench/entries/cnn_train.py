"""Entry: Contrastive Random Walk pretraining of the upstream CNN encoder
(model id 0) as the training command runs it with `--model 0`:
`CRWTrainer` (Adam, the CRW loss) on the CNN, its batches gathered on the
device from the radargram uploaded once (`gather_windows`, as
`CRWTrainer.fit` stages them), each step `train_step` on a full batch. One
request is one optimizer step; batches are consecutive full batches of
per-epoch permutations drawn from the seed (the partial batch is not
drawn). The host runs ahead of the device as in `fit`, and the window
closes once the device has finished the last step queued.

Set-up builds the trainer, loads the benchmark's CNN weights
(portbench/cnn_weights.py) with strict=True and drives it through the first
`checked_steps` steps of the same feed; the check runs the reference
(reference/cnn.py) from the same weights over the same batches and compares
as entries/train.py does: each step's loss, the first gradient as Adam
holds it (its first moment over 1 - beta1) and the parameters' change after
those steps, leaf by leaf.

Mix keys: radargrams, checked_steps, trace_seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import cnn_arith, cnn_weights, synth
from portbench.entries import common
from portbench.entries import train as crw_train
from portbench.reference import cnn as ref_cnn
from portbench.reference import crw as ref_crw
from portbench.reference import propagate as ref

BETA1 = 0.9  # torch.optim.Adam's default, which the trainer uses

request = crw_train.request
finish = crw_train.finish
counters = crw_train.counters


def setup(ctx):
    from radar_sounder_crw_tpu_torch.data.device_windows import resident_source
    from radar_sounder_crw_tpu_torch.data.radargram import RGWindows
    from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    tr = cfg["train"]
    if cfg["model"] != 0 or cfg["pos_embed"] or cfg["dtype"] != "float32" or cfg["tf32"] \
            or tr["optimizer"] != "adam" or tr["steps_per_dispatch"] != 1:
        raise ValueError("this entry runs the float32 CNN with Adam, TF32 off, no pos-embed")
    (h, w), (oh, ow) = cfg["patch"], cfg["overlap"]
    T, B = tr["seq_length"], tr["batch_size"]
    seeds = common.child_seeds(ctx.seed, 2 + mix["radargrams"])
    rg, _ = synth.radargram(cfg["rows"], cfg["width"] * mix["radargrams"], cfg["nclasses"],
                            seeds[1], dev)
    sd = cnn_weights.state_dict(seeds[0], dev, embed_dim=cfg["embed_dim"])
    rg_host = rg.cpu().numpy()
    del rg
    ds = RGWindows(rg_host, length=T, dim=(h, w), overlap=(oh, ow))
    trainer = CRWTrainer(CRWTrainConfig(
        model=0, patch_size=(h, w), seq_length=T, overlap=(oh, ow), batch_size=B,
        lr=tr["lr"], tau=tr["tau"], pos_embed=False, steps_per_dispatch=1), device=dev)
    trainer.init_state(ds[0].shape)
    trainer.model.load_state_dict(sd, strict=True)
    rg_src, geo, index_map = resident_source(ds)
    state = common.State(config=cfg, mix=mix, device=dev, seed=ctx.seed, sd=sd,
                         trainer=trainer, rg=rg_host, n_windows=len(ds), order=[],
                         rng=np.random.default_rng(seeds[-1]), B=B, T=T, geo=geo,
                         rg_dev=torch.as_tensor(rg_src, device=dev), index_map=index_map)
    state.flops = cnn_arith.train_step_flops(B, T, geo.nh, h, w)
    names = {p: n for n, p in trainer.model.named_parameters()}
    state.losses, state.grad1 = [], None
    for i in range(mix["checked_steps"]):
        state.losses.append(request(state, i, keep_loss=True))
        if i == 0:
            opt = trainer.optimizer
            # an optimizer that holds no moment for a leaf holds no gradient of it
            state.grad1 = {names[p]: opt.state[p]["exp_avg"].detach() / (1 - BETA1)
                           if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                           for p in trainer.model.parameters()}
    state.after = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    state.losses = [float(x) for x in state.losses]
    state.log.clear()
    return state


def _reference(state, n_steps, precise=True, half_batch=False):
    """(losses, first gradients, parameters after n_steps) of the reference
    from the benchmark's weights over the feed's first n_steps batches."""
    cfg = state.config
    (h, w), (oh, ow) = cfg["patch"], cfg["overlap"]
    params = {k: v.detach().clone().float() for k, v in state.sd.items()}
    trainable = list(params)
    opt = ref_crw.Adam({k: params[k] for k in trainable}, lr=cfg["train"]["lr"])
    rg = torch.as_tensor(state.rg, device=state.device)
    losses, grad1 = [], None
    with common.tf32(not precise):
        for i in range(n_steps):
            ids = state.order[i]
            if half_batch:
                ids = ids[: len(ids) // 2]
            batch = ref.windows(rg, [int(j) * (w - ow) for j in ids], state.T, state.geo.nh,
                                (h, w), (oh, ow))
            loss, grads = ref_cnn.train_step(params, trainable, opt, batch, cfg["train"]["tau"])
            losses.append(loss)
            if i == 0:
                grad1 = {k: g.detach() for k, g in grads.items()}
            del batch, grads
    return losses, grad1, {k: params[k] for k in trainable}


def check(state, limits):
    n = state.mix["checked_steps"]
    prog = (state.losses, state.grad1, state.after)
    common.release(state, "trainer", "rg_dev")
    return crw_train._numbers(state, prog, _reference(state, n), limits)


def control(state, limits, n: int = 0, fault: str = "tf32"):
    """In the program's place: the reference in TF32 ('tf32'), or in float32
    on half of each batch, the mean taken over the rest ('half_batch'),
    judged by the full reference."""
    steps = state.mix["checked_steps"]
    common.release(state, "trainer", "rg_dev")
    lo = _reference(state, steps, precise=fault != "tf32", half_batch=fault == "half_batch")
    return crw_train._numbers(state, lo, _reference(state, steps), limits)
