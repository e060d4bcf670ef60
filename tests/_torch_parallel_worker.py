"""One rank of the port's data-parallel checks (tests/test_torch_parallel.py):
gloo on the CPU, started by torch.multiprocessing.spawn. It imports torch
and the port only. Each rank writes what it computed to
`<out_dir>/rank<r>.pt`; the test compares the ranks with each other and
with one process computing the same in `run_checks(make_mesh([cpu]))`.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_threads import TORCH_THREADS
from radar_sounder_crw_tpu_torch.data import RGWindows, synthetic_radargram
from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
from radar_sounder_crw_tpu_torch.models import create_model, cross_rank_statistics, make_norm
from radar_sounder_crw_tpu_torch.ops.labelprop import LabelPropConfig
from radar_sounder_crw_tpu_torch.parallel import all_reduce_grads, make_mesh, shard_batch
from radar_sounder_crw_tpu_torch.train import (
    CRWTrainConfig,
    CRWTrainer,
    UNetTrainConfig,
    UNetTrainer,
)

LR, TAU = 1e-3, 0.05
ITEM = (3, 3, 16, 16)  # (T, N, h, w) of a CRW batch item
SHARDED, WHOLE = 8, 5  # batch sizes two ranks share, and each runs whole
UNET_HW, UNET_SHARDED, UNET_WHOLE, UNET_PREDICT = (32, 16), 4, 3, 5
SURVEY_R = 5


def batches(sizes, item, seed=0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, *item)).astype(np.float32) * 0.5 for b in sizes]


def capture_grads(trainer) -> list:
    """A list that each optimizer step of `trainer` appends its gradients
    to, as Adam receives them (after the all-reduce)."""
    seen, step = [], trainer.optimizer.step

    def recording_step(*args, **kwargs):
        seen.append({n: p.grad.clone() for n, p in trainer.model.named_parameters()})
        return step(*args, **kwargs)

    trainer.optimizer.step = recording_step
    return seen


def result(trainer, losses, grads) -> dict:
    return {"losses": losses, "grads": grads,
            "state": {k: v.clone() for k, v in trainer.model.state_dict().items()}}


def crw_run(mesh, model: int, init: dict, sizes, **kw) -> dict:
    """Losses, gradients and the final state of CRW steps on batches of
    `sizes` from the weights `init`."""
    trainer = CRWTrainer(CRWTrainConfig(model=model, lr=LR, tau=TAU, **kw), mesh=mesh)
    trainer.init_state(ITEM)
    trainer.model.load_state_dict(init, strict=True)
    grads = capture_grads(trainer)
    losses = [float(trainer.train_step(b)) for b in batches(sizes, ITEM)]
    return result(trainer, losses, grads)


def unet_run(mesh, size: int) -> dict:
    """One UNet step on a batch of `size` strips from the seed-0 init, then
    the maps of 5 strips."""
    H, W = UNET_HW
    trainer = UNetTrainer(UNetTrainConfig(patch_size=UNET_HW, n_classes=3, lr=1e-3), mesh=mesh)
    trainer.init_state((8, H, W, 1))
    grads = capture_grads(trainer)
    (x,) = batches([size], (1, H, W), seed=1)
    labels = np.random.default_rng(2).integers(0, 3, (size, H, W))
    y = torch.nn.functional.one_hot(torch.as_tensor(labels), 3).float()
    out = result(trainer, [float(trainer.train_step(torch.as_tensor(x), y))], grads)
    (strips,) = batches([UNET_PREDICT], (H, W, 1), seed=3)
    out["predict"] = trainer.predict(strips)
    return out


def bn_run(mesh, variants=None) -> dict:
    """One train-mode BatchNorm of each of `variants` {key: fused_bn value}
    (default the one-pass rule under False, two-pass under True) on this
    rank's rows of a (8, 4, 5, 5) batch inside `cross_rank_statistics`: its
    output, the gradients of its input, weight and bias under a fixed
    linear loss, and its running statistics."""
    rng = np.random.default_rng(4)
    x_all = torch.as_tensor(rng.standard_normal((8, 4, 5, 5)).astype(np.float32) + 0.3)
    r_all = torch.as_tensor(rng.standard_normal((8, 4, 5, 5)).astype(np.float32))
    out = {}
    for key, fused_bn in (variants or {False: None, True: "twopass"}).items():
        bn = make_norm(fused_bn, 4).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 4))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 4))
        x = shard_batch(x_all, mesh).clone().requires_grad_(True)
        stats = cross_rank_statistics(bn, mesh) if mesh.group is not None else contextlib.nullcontext()
        with stats:
            y = bn(x)
            (y * shard_batch(r_all, mesh)).sum().backward()
        if mesh.group is not None:
            all_reduce_grads(bn.parameters(), mesh, torch.zeros(()))
        out[key] = {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
                        "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                        "running_var": bn.running_var.clone()}
    return out


def survey_run(mesh) -> dict:
    """propagate_survey of R = 5 windows with change detection and the xent
    maps, and the reverse pass."""
    rg, seg = synthetic_radargram(H=96, W=1200, nclasses=4, seed=5)
    ds = RGWindows(rg, length=8, dim=(16, 16), overlap=(8, 0))
    pipe = PropagationPipeline(create_model(1, False, device=mesh.device, seed=0),
                               LabelPropConfig(cxt_size=4, radius=3, temperature=0.1, knn=4),
                               4, device=mesh.device)
    ids = list(range(0, 8 * SURVEY_R, 8))[:SURVEY_R]
    refs = [seg[:96, 64 * t: 64 * t + 16] for t in range(SURVEY_R)]
    pred, change, xent = pipe.propagate_survey(ds, ids, refs, mesh=mesh, detect_change=True,
                                               return_xent=True)
    rev = pipe.propagate_survey(ds, ids, refs, mesh=mesh, use_last=True)
    return {"pred": pred, "change": change, "xent": xent, "rev": rev}


def run_checks(mesh, inits: dict) -> dict:
    """Everything a rank computes: the CNN's sharded step then its whole
    (replicated) one; the ResNet's sharded step (one-pass, and two-pass
    with remat) and whole step from the init; the UNet's alike; the
    survey; one BatchNorm alone."""
    return {
        "cnn": crw_run(mesh, 0, inits["cnn"], (SHARDED, WHOLE)),
        "resnet_sharded": crw_run(mesh, 1, inits["resnet"], (SHARDED,)),
        "resnet_twopass_remat_sharded": crw_run(mesh, 1, inits["resnet"], (SHARDED,),
                                                fused_bn="twopass", remat=True),
        "resnet_whole": crw_run(mesh, 1, inits["resnet"], (WHOLE,)),
        "unet_sharded": unet_run(mesh, UNET_SHARDED),
        "unet_whole": unet_run(mesh, UNET_WHOLE),
        "survey": survey_run(mesh),
        "bn": bn_run(mesh),
    }


def fused_bn_checks(mesh, inits: dict) -> dict:
    """The ResNet with models/fused_bn.py's BatchNorms ('fused', 'lean'): a
    sharded step and a whole one from the init, and each BatchNorm alone."""
    out = {}
    for variant in ("fused", "lean"):
        for name, size in (("sharded", SHARDED), ("whole", WHOLE)):
            out[f"resnet_{variant}_{name}"] = crw_run(mesh, 1, inits["resnet"], (size,),
                                                      fused_bn=variant)
    out["bn"] = bn_run(mesh, {"fused": "fused", "lean": "lean"})
    return out


def rank_main(rank: int, world: int, init_file: str, out_dir: str,
              checks: str = "run_checks") -> None:
    torch.set_num_threads(TORCH_THREADS)  # the one process's: the same kernels' sums
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh()
        inits = torch.load(os.path.join(out_dir, "inits.pt"), weights_only=True)
        result = globals()[checks](mesh, inits)
        result["mesh"] = (mesh.size, mesh.rank, str(mesh.device))
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
