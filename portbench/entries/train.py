"""Driver: Contrastive Random Walk pretraining as the training command runs
it by default: `CRWTrainer` (Adam, train-mode BatchNorm, the CRW loss), its
batches gathered on the device from the radargram uploaded once
(`gather_windows`, as `CRWTrainer.fit` stages them), in an order shuffled
by the seed, each step `train_step` on a full batch. One request is one
optimizer step; the host runs ahead of the device as in `fit`, and the
window closes once the device has finished the last step queued.

Set-up builds the trainer, loads the benchmark's weights and drives it
through the first `checked_steps` steps of the same feed; the check runs the
reference from the same weights over the same batches and compares each
step's loss, the first gradient as Adam holds it (its first moment over
1 - beta1) and the parameters' change after those steps, leaf by leaf.
Checkpoints, plots and the epoch log are left out; partial batches are not
drawn.

Mix keys: radargrams, checked_steps, trace_seconds.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from portbench import arith, synth
from portbench.entries import common
from portbench.reference import crw as ref_crw
from portbench.reference import propagate as ref
from portbench.trace import span

BETA1 = 0.9  # torch.optim.Adam's default, which the trainer uses


def setup(ctx):
    from radar_sounder_crw_tpu_torch.data.device_windows import resident_source
    from radar_sounder_crw_tpu_torch.data.radargram import RGWindows
    from radar_sounder_crw_tpu_torch.train import CRWTrainConfig, CRWTrainer

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    tr = cfg["train"]
    if cfg["dtype"] != "float32" or cfg["tf32"] or tr["fused_bn"] is not None \
            or tr["steps_per_dispatch"] != 1:
        raise ValueError("this driver runs the float32 default trainer")
    (h, w), (oh, ow) = cfg["patch"], cfg["overlap"]
    T, B = tr["seq_length"], tr["batch_size"]
    seeds = common.child_seeds(ctx.seed, 2 + mix["radargrams"])
    rg, _ = synth.radargram(cfg["rows"], cfg["width"] * mix["radargrams"], cfg["nclasses"],
                            seeds[1], dev)
    sd = common.make_weights(cfg, seeds[0], dev, rg)
    rg_host = rg.cpu().numpy()
    del rg
    ds = RGWindows(rg_host, length=T, dim=(h, w), overlap=(oh, ow))
    trainer = CRWTrainer(CRWTrainConfig(
        model=cfg["model"], patch_size=(h, w), seq_length=T, overlap=(oh, ow), batch_size=B,
        lr=tr["lr"], tau=tr["tau"], pos_embed=cfg["pos_embed"], fused_bn=None,
        steps_per_dispatch=1), device=dev)
    trainer.init_state(ds[0].shape)
    trainer.model.load_state_dict(sd, strict=True)
    rg_src, geo, index_map = resident_source(ds)
    state = common.State(config=cfg, mix=mix, device=dev, seed=ctx.seed, sd=sd,
                         trainer=trainer, rg=rg_host, n_windows=len(ds), order=[],
                         rng=np.random.default_rng(seeds[-1]), B=B, T=T, geo=geo,
                         rg_dev=torch.as_tensor(rg_src, device=dev), index_map=index_map)
    N = geo.nh
    state.flops = arith.train_step_flops(B, T, N, h, w)
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


def _batch_ids(state, i):
    """Window ids of step i: consecutive full batches of per-epoch
    permutations drawn from the seed."""
    per_epoch = state.n_windows // state.B
    while len(state.order) <= i:
        perm = state.rng.permutation(state.n_windows)
        state.order.extend(perm[k * state.B:(k + 1) * state.B] for k in range(per_epoch))
    return state.order[i]


def request(state, i, keep_loss=False):
    ids = _batch_ids(state, i)
    with span("train.gather"):
        idx = torch.as_tensor(state.index_map[ids].astype(np.int64)).to(state.device)
        from radar_sounder_crw_tpu_torch.data.device_windows import gather_windows

        batch = gather_windows(state.rg_dev, idx, state.geo)
    with span("train.step"):
        loss = state.trainer.train_step(batch)
    state.log.append({"flops": state.flops})
    return loss if keep_loss else 1


def finish(state):
    common.synchronize(state.device)


def counters(state):
    return {}


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in d.items()}


def _worst_leaf(prog: dict, refn: dict, keep, what: str) -> float:
    """max over leaves of |norm_prog - norm_ref| / max(norm_ref, median leaf's norm)."""
    med = float(np.median([refn[k] for k in keep]))
    gaps = {k: abs(prog[k] - refn[k]) / max(refn[k], med) for k in keep}
    worst = max(gaps, key=gaps.get)
    print(f"[portbench] {what}: worst leaf {worst} (program {prog[worst]!r}, reference "
          f"{refn[worst]!r}, median leaf {med!r})", file=sys.stderr)
    return gaps[worst]


def _reference(state, n_steps, batches_of, precise=True, half_batch=False):
    """(losses, first gradients, parameters after n_steps) of the reference
    from the benchmark's weights."""
    cfg = state.config
    (h, w), (oh, ow) = cfg["patch"], cfg["overlap"]
    N = state.geo.nh
    params = {k: v.detach().clone().float() for k, v in state.sd.items()}
    trainable = [k for k in params if not k.split(".")[-1].startswith(("running_", "num_"))]
    opt = ref_crw.Adam({k: params[k] for k in trainable}, lr=cfg["train"]["lr"])
    rg = torch.as_tensor(state.rg, device=state.device)
    losses, grad1 = [], None
    with common.tf32(not precise):
        for i in range(n_steps):
            ids = batches_of(i)
            if half_batch:
                ids = ids[: len(ids) // 2]
            batch = ref.windows(rg, [int(j) * (w - ow) for j in ids], state.T, N, (h, w), (oh, ow))
            loss, grads = ref_crw.train_step(params, trainable, opt, batch, cfg["train"]["tau"])
            losses.append(loss)
            if i == 0:
                grad1 = {k: g.detach() for k, g in grads.items()}
            del batch, grads
    return losses, grad1, {k: params[k] for k in trainable}


def _numbers(state, prog, refr, limits):
    p_loss, p_grad, p_after = prog
    r_loss, r_grad, r_after = refr
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_loss, r_loss))
    gn_r, gn_p = _norms(r_grad), _norms(p_grad)
    med = float(np.median(list(gn_r.values())))
    moving = [k for k in gn_r if gn_r[k] >= 1e-3 * med]  # nought to rounding otherwise
    grad_gap = _worst_leaf(gn_p, gn_r, list(gn_r), "first gradient")
    w0 = {k: v.float() for k, v in state.sd.items()}
    dn_r = _norms({k: r_after[k] - w0[k] for k in moving})
    dn_p = _norms({k: p_after[k] - w0[k] for k in moving})
    change_gap = _worst_leaf(dn_p, dn_r, moving, "change")
    return [("loss_rel_gap", float(loss_gap), limits.get("loss_rel_gap")),
            ("grad_leaf_gap", float(grad_gap), limits.get("grad_leaf_gap")),
            ("change_leaf_gap", float(change_gap), limits.get("change_leaf_gap"))]


def check(state, limits):
    n = state.mix["checked_steps"]
    prog = (state.losses, state.grad1, state.after)
    common.release(state, "trainer", "rg_dev")
    return _numbers(state, prog, _reference(state, n, lambda i: state.order[i]), limits)


def control(state, limits, n: int = 0, fault: str = "tf32"):
    """In the program's place: the reference in TF32 ('tf32'), or in float32
    on half of each batch, the mean taken over the rest ('half_batch'),
    judged by the full reference."""
    steps = state.mix["checked_steps"]
    common.release(state, "trainer", "rg_dev")
    lo = _reference(state, steps, lambda i: state.order[i], precise=fault != "tf32",
                    half_batch=fault == "half_batch")
    return _numbers(state, lo, _reference(state, steps, lambda i: state.order[i]), limits)
