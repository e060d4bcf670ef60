"""Supervised UNet baseline trainer (SHARAD strips), data parallel over a
mesh as the CRW trainer is (train/crw_trainer.py).

Follows radar_sounder_crw_tpu/train/unet_trainer.py (the reference's
scripts/test/test_unet.py): unfold the radargram into full-height strips,
one-hot the ground truth, a seeded 90/10 split, Adam, train, then the
classification report on the held-out strips. The reference's loss quirk is
kept behind `quirk_double_softmax` (default on): the logits are
soft-maxed and the cross-entropy then applied to the probabilities. The
loss is the per-item mean over H and W, weighted. The shuffle is keyed by
(seed, epoch index); a partial last batch is a smaller batch (exact
BatchNorm statistics). With `device_resident` the strips and their integer
labels are uploaded once and each step rebuilds its one-hot on the device,
which equals the host batch exactly when the labels are one-hot
(`gather`). The step's phases run in the spans `crw.unet.gather`,
`crw.unet.forward`, `crw.unet.loss`, `crw.unet.backward` (zero_grad and
the backward) and `crw.unet.optimizer` (the all-reduce on a mesh and
Adam's step). On a
mesh of several ranks a batch the mesh divides runs sharded (BatchNorm
statistics over the ranks, gradients and loss summed), a partial one whole
on every rank; `predict` pads the strips to the mesh, splits them and
gathers the maps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..models.resnet import cross_rank_statistics
from ..models.unet import create_unet
from ..parallel.mesh import (
    all_gather,
    all_reduce_grads,
    default_mesh,
    pad_to_multiple,
    shard_batch,
)
from ..utils.device import parity_mode
from ..utils.profiling import span


@dataclasses.dataclass
class UNetTrainConfig:
    patch_size: tuple[int, int] = (912, 64)
    split: float = 0.9
    batch_size: int = 64
    epochs: int = 100
    lr: float = 1e-4
    n_classes: int = 5
    seed: int = 11
    quirk_double_softmax: bool = True
    dtype: torch.dtype = torch.float32  # compute dtype (bfloat16: autocast)
    device_resident: bool | None = None  # None = when y is exactly one-hot;
    # False = host batches; True = raise on soft labels


def unfold_strips(rg: np.ndarray, seg: np.ndarray, strip_w: int, n_classes: int):
    """Radargram + GT -> (samples (S, H, W, 1) float32, one-hot (S, H, W, M))
    (reference: scripts/test/test_unet.py:34-40; width-strided unfold)."""
    H, W = rg.shape
    S = W // strip_w
    x = rg[:, : S * strip_w].reshape(H, S, strip_w).transpose(1, 0, 2)
    y = seg[:, : S * strip_w].reshape(H, S, strip_w).transpose(1, 0, 2)
    onehot = np.eye(n_classes, dtype=np.float32)[y.astype(np.int64)]
    return x[..., None].astype(np.float32), onehot


def train_test_split(n: int, split: float, seed: int):
    """Index split mirroring the reference's random 90/10
    (reference: scripts/test/test_unet.py:43-46)."""
    order = np.random.default_rng(seed).permutation(n)
    n_train = int(split * n)
    return order[:n_train], order[n_train:]


def _exact_onehot(y: np.ndarray, n_classes: int) -> bool:
    return bool(
        y.shape[-1] == n_classes
        and ((y == 0.0) | (y == 1.0)).all()
        and (y.sum(axis=-1) == 1.0).all()
    )


class UNetTrainer:
    """Owns the UNet, Adam and the epoch loop on this rank's device of
    `mesh` (without one: the process group's when initialised, else one
    device, `device`, default cuda; raises without it, CPU runs pass
    device='cpu'). Inputs are NHWC numpy strips (S, H, W, 1) with one-hot
    labels (S, H, W, M), as unfold_strips gives them."""

    def __init__(self, config: UNetTrainConfig, device=None, mesh=None):
        self.config = config
        self.mesh = default_mesh(device) if mesh is None else mesh
        self.device = self.mesh.device
        parity_mode()
        self.model = None
        self.optimizer = None
        self.step = 0
        self._epoch_idx = 0
        self._resident_data = None  # (x, y, x on the device, labels on the device)

    def init_state(self, sample_shape):
        """Fresh UNet (seed `config.seed`) and Adam; sample shape (S, H, W, 1)."""
        cfg = self.config
        self._init_shape = tuple(int(d) for d in sample_shape)
        self.model = create_unet(1, cfg.n_classes, bilinear=True, dtype=cfg.dtype,
                                 device=self.device, seed=cfg.seed)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr)
        self.step = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict):
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def loss(self, logits: torch.Tensor, onehot: torch.Tensor, weights: torch.Tensor,
             total=None):
        """logits (B, M, H, W), onehot (B, H, W, M), weights (B,) -> scalar:
        the weighted mean of the per-item losses, divided by `total` in place
        of the weights' sum when given (a shard's share of a batch)."""
        logits = logits.permute(0, 2, 3, 1)
        if self.config.quirk_double_softmax:
            logp = F.log_softmax(F.softmax(logits, dim=-1), dim=-1)
        else:
            logp = F.log_softmax(logits, dim=-1)
        per_item = -(onehot * logp).sum(dim=-1).mean(dim=(1, 2))
        return (per_item * weights).sum() / (weights.sum() if total is None else total)

    def train_step(self, x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        """One Adam step on the batch x (B, 1, H, W), onehot (B, H, W, M),
        device tensors; the whole batch's loss (detached). The whole step
        runs in the span `crw.unet.step`."""
        with span("crw.unet.step"):
            B = x.shape[0]
            sharded = self.mesh.shards(B)
            if sharded:
                x, onehot = shard_batch(x, self.mesh), shard_batch(onehot, self.mesh)
            return self._run(x, onehot, B, sharded)

    def _run(self, x, onehot, batch_size: int, sharded: bool) -> torch.Tensor:
        """The step on this rank's rows of a batch of `batch_size`: sharded,
        the loss is the rows' share of the batch's and BatchNorm, gradients
        and loss are reduced over the ranks."""
        self.model.train()
        mesh = self.mesh if sharded else None
        stats = contextlib.nullcontext() if mesh is None else cross_rank_statistics(
            self.model, mesh)
        with stats:
            with span("crw.unet.forward"):
                logits = self.model(x)
            with span("crw.unet.loss"):
                weights = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
                loss = self.loss(logits, onehot, weights,
                                 float(batch_size) if sharded else None)
            with span("crw.unet.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
        loss = loss.detach()
        with span("crw.unet.optimizer"):
            if mesh is not None:
                loss = all_reduce_grads(self.model.parameters(), mesh, loss)
            self.optimizer.step()
        self.step += 1
        return loss

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

    def make_resident(self, x, y):
        """Upload NHWC strips x (S, H, W, 1) and their one-hot labels y
        (S, H, W, M) once, as (strips (S, 1, H, W), int labels (S, H, W)) on
        the device, for `gather`; None where the labels are not exactly
        one-hot or `device_resident` is False (host batches)."""
        cfg = self.config
        if cfg.device_resident is False:
            return None
        cached = self._resident_data
        if cached is not None and cached[0] is x and cached[1] is y:
            return cached[2], cached[3]
        y_arr = np.asarray(y)
        if not _exact_onehot(y_arr, cfg.n_classes):
            if cfg.device_resident is True:
                raise ValueError(
                    "device_resident=True needs exactly one-hot labels (soft labels "
                    "cannot round-trip through the compact int encoding)"
                )
            self._resident_data = None  # `gather` must not serve earlier strips
            return None
        x_dev = self._to_device(x).permute(0, 3, 1, 2).contiguous()
        labels_dev = torch.as_tensor(y_arr.argmax(axis=-1)).to(self.device)
        self._resident_data = (x, y, x_dev, labels_dev)
        return x_dev, labels_dev

    def gather(self, ids) -> tuple[torch.Tensor, torch.Tensor]:
        """The device batch (x (B, 1, H, W), one-hot (B, H, W, M)) of the
        resident strips `ids` (host indices into the strips `make_resident`
        uploaded last)."""
        if self._resident_data is None:
            raise ValueError("no resident strips: call make_resident first")
        with span("crw.unet.gather"):
            x_dev, labels_dev = self._resident_data[2:]
            ids = torch.as_tensor(ids).to(self.device)
            return x_dev[ids], F.one_hot(labels_dev[ids], self.config.n_classes).float()

    def fit(self, x, y, log: Callable[[str], None] = print) -> list[float]:
        """Epoch loop; on a mesh each rank takes its rows of every batch
        (rank 0 alone logs)."""
        cfg = self.config
        if self.mesh.rank != 0:
            log = lambda _msg: None  # noqa: E731 (rank 0 alone logs)
        if self.model is None:
            self.init_state(x.shape)
        steps_per_epoch = max(1, -(-len(x) // cfg.batch_size))
        if self._epoch_idx == 0 and self.step > 0:
            self._epoch_idx = self.step // steps_per_epoch
        resident = self.make_resident(x, y)

        history = []
        for epoch in range(cfg.epochs):
            t0 = time.time()
            order = np.random.default_rng([cfg.seed, self._epoch_idx]).permutation(len(x))
            self._epoch_idx += 1
            losses = []
            for s in range(0, len(order), cfg.batch_size):
                idx = order[s: s + cfg.batch_size]
                B, sharded = len(idx), self.mesh.shards(len(idx))
                if sharded:
                    idx = shard_batch(idx, self.mesh)
                if resident is not None:
                    bx, by = self.gather(idx)
                else:
                    bx = self._to_device(x[idx]).permute(0, 3, 1, 2)
                    by = self._to_device(y[idx])
                losses.append(self._run(bx, by, B, sharded))
            epoch_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
            history.append(epoch_loss)
            log(f"Epoch: {epoch + 1} Loss: {epoch_loss} Time: {time.time() - t0:.3f}")
        return history

    @torch.no_grad()
    def predict(self, x) -> np.ndarray:
        """Eval-mode argmax class map (B, H, W) int32 of NHWC strips. On a
        mesh the strips are padded to a multiple of its size (the last one
        repeated), each rank maps its share and every rank returns all B."""
        self.model.eval()
        x, real = pad_to_multiple(np.asarray(x, np.float32), self.mesh.size)
        if self.mesh.group is not None:
            x = shard_batch(x, self.mesh)
        pred = self.model(self._to_device(x).permute(0, 3, 1, 2)).argmax(dim=1).to(torch.int32)
        if self.mesh.group is not None:
            pred = all_gather(pred, self.mesh)
        return pred[:real].cpu().numpy()

