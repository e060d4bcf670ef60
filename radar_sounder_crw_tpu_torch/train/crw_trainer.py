"""CRW unsupervised trainer: Adam, the train step, the epoch loop, data
parallel over a mesh (parallel/mesh.py).

Follows radar_sounder_crw_tpu/train/crw_trainer.py (itself the reference
trainer, scripts/train.py:39-93): Adam, per-epoch mean loss and wall time,
batches shuffled by (seed, global epoch index), seed 11, the encoder
exported at the end. A step encodes the B*T*N patches in train mode, takes
the per-item CRW loss, weights it (sum(per_item * w) / sum(w)), backpropagates
and steps Adam. Batches are gathered on the device from the radargram
uploaded once (`device_resident`) or stacked on the host, the next one
staged while the current step runs.

On a mesh of several ranks (one process a device) a batch that the mesh
divides runs sharded: each rank takes its rows, BatchNorm takes its
statistics over the ranks, each rank's loss is its rows' share of the
whole batch's, and the gradients and the loss are summed over the ranks in
one buffer before Adam, so every rank holds the parameters one device would.
A batch that the mesh does not divide (the partial last one) runs whole on
every rank with no collective, which keeps its BatchNorm statistics exact.

`steps_per_dispatch = k` cuts each epoch into chunks of k full batches, as
the JAX trainer's scanned `multi_step` does: on the card a chunk is one
CUDA graph replay of k captured steps (train/step_graph.py; the first
chunk's steps run eagerly and warm the capture up), on the CPU k eager
steps; a partial chunk runs as plain steps. Such a trainer's Adam is
`capturable` on the card. `fused_bn` picks the ResNet's BatchNorm as the
JAX package's `make_norm` does (models/resnet.py). The TPU knob `s2d_stem`
(a layout of the same stem) is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..data.device_windows import gather_windows, resident_source
from ..models import create_model, param_count
from ..models.resnet import cross_rank_statistics, frozen_statistics
from ..ops.crw import crw_loss
from ..parallel.mesh import all_reduce_grads, default_mesh, shard_batch
from ..utils.device import parity_mode
from ..utils.pos_embed import maybe_pos_embed
from ..utils.profiling import span
from .step_graph import StepGraph


@dataclasses.dataclass
class CRWTrainConfig:
    """Training hyperparameters (defaults = reference scripts/train.py:17-37)."""

    model: int = 1  # 0=CNN, 1=ResNet
    patch_size: tuple[int, int] = (16, 16)
    seq_length: int = 20
    overlap: tuple[int, int] = (8, 0)
    batch_size: int = 8
    epochs: int = 2
    lr: float = 1e-3
    tau: float = 0.01
    pos_embed: bool = False
    seed: int = 11
    dtype: torch.dtype = torch.float32  # encoder compute dtype (bfloat16: autocast)
    remat: bool = False  # recompute the encoder's activations in the backward
    device_resident: bool | None = None  # gather batches on the device from the
    # radargram(s) uploaded once; None = whenever the dataset serves windows of
    # host radargrams (data/device_windows.resident_source), False = host
    # batches, True = raise where the dataset does not allow it
    steps_per_dispatch: int = 1  # k optimizer steps a dispatch: one CUDA graph
    # replay of k captured steps on the card, k eager steps on the CPU (the
    # same arithmetic); partial chunks run as plain steps
    fused_bn: bool | str | None = None  # the ResNet's BatchNorm
    # (models/resnet.py make_norm): None one-pass, 'twopass', True/'fused'
    # the BatchNorm kernels of csrc/bn_train.cu, 'lean' bf16-read statistics


def make_crw_train_step(model, optimizer, tau: float, use_pos_embed: bool,
                        remat: bool = False) -> Callable:
    """(seq (B, T, N, h, w), weights (B,)) -> the step's loss (a detached
    0-d tensor), after the Adam update. With remat the encoder forward runs
    under activation checkpointing; its recompute leaves the BatchNorm
    running statistics alone, so they are updated once a step.

    With `mesh`, seq and weights are this rank's shard of a batch whose
    weights sum to `total`: BatchNorm takes its statistics over the ranks
    (the recompute of remat too, so every rank issues the same
    collectives), the rank's loss is sum(per_item * w) / total, and the
    gradients and the loss are summed over the ranks before Adam.

    The step's phases run in the spans `crw.encode` (the forward; with
    remat its recompute too, inside the backward), `crw.loss` (the
    weighted CRW loss), `crw.backward` (zero_grad and the backward) and
    `crw.optimizer` (the all-reduce on a mesh and Adam's step). Inside a
    captured CUDA graph (steps_per_dispatch > 1 on the card) the spans
    fire while the graph is captured, not when it is replayed."""

    def encode(seq):
        with span("crw.encode"):
            B, T, N, h, w = seq.shape
            x = maybe_pos_embed(seq.reshape(B * T * N, 1, h, w), use_pos_embed)
            return model(x).reshape(B, T, N, -1)

    def no_update_on_recompute():
        return contextlib.nullcontext(), frozen_statistics(model)

    def step(seq, weights, mesh=None, total=None):
        model.train()
        stats = contextlib.nullcontext() if mesh is None else cross_rank_statistics(model, mesh)
        with stats:
            if remat:  # the encoder draws no random numbers: no RNG state to keep
                emb = checkpoint(encode, seq, use_reentrant=False, preserve_rng_state=False,
                                 context_fn=no_update_on_recompute)
            else:
                emb = encode(seq)
            with span("crw.loss"):
                per_item, _ = crw_loss(emb, tau, per_item=True)
                loss = (per_item * weights).sum() / (weights.sum() if total is None else total)
            with span("crw.backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
        loss = loss.detach()
        with span("crw.optimizer"):
            if mesh is not None:
                loss = all_reduce_grads(model.parameters(), mesh, loss)
            optimizer.step()
        return loss

    return step


def _loss_step(step_fn, mesh, seq: torch.Tensor, batch_size: int, sharded: bool) -> torch.Tensor:
    """One step of `step_fn` on this rank's rows `seq` of a batch of
    `batch_size`, every item weighted 1."""
    weights = torch.ones(seq.shape[0], dtype=torch.float32, device=seq.device)
    if sharded:
        return step_fn(seq, weights, mesh, float(batch_size))
    return step_fn(seq, weights)


class CRWTrainer:
    """Owns the encoder, Adam, the step and the epoch loop on this rank's
    device of `mesh`. Without a mesh: the process group's when one is
    initialised (parallel.init_distributed), else one device, `device`
    (default cuda; raises without it, CPU runs pass device='cpu'). Every
    rank holds the same encoder and Adam state; rank 0 alone logs."""

    def __init__(self, config: CRWTrainConfig, device=None, mesh=None):
        self.config = config
        self.mesh = default_mesh(device) if mesh is None else mesh
        self.device = self.mesh.device
        parity_mode()
        self.model = None
        self.optimizer = None
        self.step = 0
        self._epoch_idx = 0  # global epoch counter driving the shuffle order
        self._resident_rg = None  # (host array, its upload)
        self._chunks = {}  # static buffers and StepGraph of each k-step chunk shape

    # -- lifecycle -----------------------------------------------------------
    def init_state(self, example_item_shape):
        """Fresh encoder (seed `config.seed`) and Adam; item shape (T, N, h, w)."""
        cfg = self.config
        self._init_shape = tuple(int(d) for d in example_item_shape)
        self.model = create_model(cfg.model, cfg.pos_embed, device=self.device, seed=cfg.seed,
                                  dtype=cfg.dtype, fused_bn=cfg.fused_bn)
        # a CUDA graph of Adam's steps needs its step counts on the card
        capturable = self._k() > 1 and self.device.type == "cuda"
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                          capturable=capturable)
        self._step_fn = make_crw_train_step(self.model, self.optimizer, cfg.tau,
                                            cfg.pos_embed, cfg.remat)
        self._chunks = {}
        self.step = 0
        self.n_params = param_count(self.model)

    def state_dict(self) -> dict:
        """What a checkpoint holds: the model with its buffers, Adam's state
        and the step count."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict):
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])  # new state tensors:
        self._chunks = {}  # a captured graph would update the old ones
        self.step = int(state["step"])

    def variables(self) -> dict:
        """The encoder's state_dict (reference names, CPU tensors)."""
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    # -- steps ---------------------------------------------------------------
    def _upload(self, batch) -> torch.Tensor:
        """A host batch onto the device without waiting for the copy, in
        the span `crw.upload`."""
        with span("crw.upload"):
            t = torch.as_tensor(np.asarray(batch, np.float32))
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a batch (B, T, N, h, w) of any size: a host
        array, or a tensor already on the device (after `init_state`). The
        loss is the whole batch's, on every rank. The whole step runs in the
        span `crw.step`."""
        with span("crw.step"):
            B = batch.shape[0]
            sharded = self.mesh.shards(B)
            if sharded:
                batch = shard_batch(batch, self.mesh)
            seq = batch if isinstance(batch, torch.Tensor) else self._upload(batch)
            return self._run(seq.to(self.device, torch.float32), B, sharded)

    def _run(self, seq: torch.Tensor, batch_size: int, sharded: bool) -> torch.Tensor:
        """The step on this rank's rows `seq` of a batch of `batch_size`."""
        loss = _loss_step(self._step_fn, self.mesh, seq, batch_size, sharded)
        self.step += 1
        return loss

    # -- k steps a dispatch ----------------------------------------------------
    def _k(self) -> int:
        return max(1, int(self.config.steps_per_dispatch))

    def train_chunk(self, batches) -> torch.Tensor:
        """k = len(batches) optimizer steps on batches (k, B, T, N, h, w) of
        full size, a host array or a tensor on the device, as one dispatch:
        one CUDA graph replay on the card (the first chunk of a shape runs
        eagerly and is captured), k eager steps on the CPU. Returns the
        (k,) losses, each the whole batch's."""
        B = batches.shape[1]
        sharded = self.mesh.shards(B)
        if sharded:
            rows = [shard_batch(b, self.mesh) for b in batches]
            batches = torch.stack(rows) if isinstance(batches, torch.Tensor) else np.stack(rows)
        return self._dispatch(("host", tuple(batches.shape), B, sharded), batches)

    def _dispatch(self, key: tuple, data) -> torch.Tensor:
        """One chunk: `data` (the k batches, or with key[0] == 'resident'
        their window ids) into the static buffer of `key`, then its steps."""
        if key not in self._chunks:
            self._chunks[key] = self._make_chunk(key)
        buffer, losses, run = self._chunks[key]
        if isinstance(data, torch.Tensor):
            buffer.copy_(data, non_blocking=True)
        else:
            host = torch.as_tensor(np.asarray(data, dtype=np.float32 if key[0] == "host"
                                              else np.int64))
            buffer.copy_(host.pin_memory() if self.device.type == "cuda" else host,
                         non_blocking=True)
        run()
        self.step += buffer.shape[0]
        return losses.clone()

    def _make_chunk(self, key: tuple):
        """(static input buffer, static (k,) loss buffer, StepGraph) of a
        chunk: key ('host', shape, B, sharded) reads the k batches from the
        buffer, key ('resident', shape, B, sharded, geo) gathers them from
        the uploaded radargram by the window ids in the buffer."""
        kind, shape, B, sharded = key[:4]
        if self.device.type == "cuda" and self.mesh.group is not None:
            backend = dist.get_backend(self.mesh.group)
            if backend != "nccl":
                raise ValueError(
                    f"steps_per_dispatch > 1 on the card captures the steps in a CUDA graph, "
                    f"and {backend} collectives on CUDA tensors cannot be captured (NCCL can)")
        buffer = torch.zeros(shape, dtype=torch.float32 if kind == "host" else torch.int64,
                             device=self.device)
        losses = torch.zeros(shape[0], dtype=torch.float32, device=self.device)
        rg = self._resident_rg[1] if kind == "resident" else None
        step_fn, mesh = self._step_fn, self.mesh  # not self: the trainer owns the graph

        def body():
            for j in range(shape[0]):
                seq = buffer[j] if rg is None else gather_windows(rg, buffer[j], key[4])
                losses[j].copy_(_loss_step(step_fn, mesh, seq, B, sharded))

        return buffer, losses, StepGraph(body, self.device)

    def _resident(self, dataset):
        """(radargram on the device, geometry, index map) or None."""
        cfg = self.config
        if cfg.device_resident is False:
            return None
        source = resident_source(dataset)
        if source is None:
            if cfg.device_resident is True:
                raise ValueError(
                    "device_resident=True needs a window dataset over host radargrams "
                    "(RGWindows, ConcatWindows of RGWindows with one windowing geometry, "
                    "or SubsetWindows over either)"
                )
            return None
        rg_host, geo, index_map = source
        # the upload survives fit() calls (one epoch a call), keyed on
        # the host array's identity
        if self._resident_rg is None or self._resident_rg[0] is not rg_host:
            rg_dev = torch.as_tensor(np.asarray(rg_host, np.float32)).to(self.device)
            self._resident_rg = (rg_host, rg_dev)
            self._chunks = {k: v for k, v in self._chunks.items() if k[0] != "resident"}
        return self._resident_rg[1], geo, index_map

    def fit(self, dataset, log: Callable[[str], None] = print) -> list[float]:
        """Epoch loop (reference: scripts/train.py:62-75): per epoch a
        permutation keyed by (seed, global epoch index), batches in order,
        the mean loss and wall time logged. A restored trainer continues the
        schedule from step // steps_per_epoch (same dataset length and batch
        size as the run that saved it). On a mesh every rank runs the same
        schedule on its rows of each batch; rank 0 alone logs. With
        steps_per_dispatch = k > 1 (and a batch size the mesh divides) each
        run of k full batches is one dispatch (`train_chunk`), the rest
        plain steps."""
        cfg = self.config
        if self.mesh.rank != 0:
            log = lambda _msg: None  # noqa: E731 (rank 0 alone logs)
        if self.model is None:
            self.init_state(dataset[0].shape)
        steps_per_epoch = max(1, -(-len(dataset) // cfg.batch_size))
        k = self._k()
        if self._epoch_idx == 0 and self.step > 0:
            self._epoch_idx = self.step // steps_per_epoch
        resident = self._resident(dataset)

        history = []
        for epoch in range(cfg.epochs):
            t0 = time.time()
            order = np.random.default_rng([cfg.seed, self._epoch_idx]).permutation(len(dataset))
            self._epoch_idx += 1
            starts = list(range(0, len(order), cfg.batch_size))

            def stage(si):
                """(this rank's rows of batch si on the device, batch size,
                sharded)."""
                idxs = order[starts[si]: starts[si] + cfg.batch_size]
                B, sharded = len(idxs), self.mesh.shards(len(idxs))
                if sharded:
                    idxs = shard_batch(idxs, self.mesh)
                if resident is not None:
                    rg_dev, geo, index_map = resident
                    ids = torch.as_tensor(index_map[idxs].astype(np.int64)).to(self.device)
                    return gather_windows(rg_dev, ids, geo), B, sharded
                return self._upload(np.stack([dataset[int(i)] for i in idxs])), B, sharded

            losses = []
            if k > 1 and cfg.batch_size % self.mesh.size == 0:
                si = 0
                while si < len(starts):
                    kk = min(k, len(starts) - si)
                    batches = [order[starts[si + j]: starts[si + j] + cfg.batch_size]
                               for j in range(kk)]
                    if kk == k and all(len(b) == cfg.batch_size for b in batches):
                        losses.extend(self._dispatch_batches(batches, dataset, resident))
                    else:  # the tail: plain steps
                        losses.extend(self._run(*stage(si + j)) for j in range(kk))
                    si += kk
            else:
                staged = stage(0) if starts else None
                for si in range(len(starts)):
                    args = staged
                    if si + 1 < len(starts):
                        staged = stage(si + 1)  # prefetch while this step runs
                    losses.append(self._run(*args))
            epoch_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
            history.append(epoch_loss)
            log(f"Epoch: {epoch} Loss: {epoch_loss} Time: {time.time() - t0:.3f}")
        return history


    def _dispatch_batches(self, batches: list, dataset, resident) -> list[torch.Tensor]:
        """k full batches of dataset indices as one dispatch: their window
        ids into the resident chunk's buffer, or the windows themselves into
        the host chunk's."""
        B = len(batches[0])
        sharded = self.mesh.shards(B)
        if sharded:
            batches = [shard_batch(b, self.mesh) for b in batches]
        if resident is not None:
            _, geo, index_map = resident
            ids = np.stack([index_map[b] for b in batches]).astype(np.int64)
            key = ("resident", ids.shape, B, sharded, geo)
            return list(self._dispatch(key, ids).unbind(0))
        data = np.stack([np.stack([dataset[int(i)] for i in b]) for b in batches])
        return list(self._dispatch(("host", data.shape, B, sharded), data).unbind(0))
