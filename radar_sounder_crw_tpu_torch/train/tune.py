"""Hyperparameter search: random sampling + ASHA-style successive halving.

A port of radar_sounder_crw_tpu/train/tune.py, function for function (the
capability of the reference's Ray Tune path, scripts/train.py:107-146:
tune.choice grids, ASHAScheduler's max_t / grace_period /
reduction_factor, num_samples, per-trial checkpoints, a best-trial report),
without Ray.

Parallelism: with `devices`, trials are pinned one per device (sticky,
trial i on device i mod len(devices)) and each device's trials run on a
worker thread of their own, which enters that device; each trial's trainer
is built on a one-device mesh (`make_mesh([dev])`). PyTorch releases the
interpreter lock in its kernels and CUDA launches are asynchronous, so the
devices overlap. Rungs stay synchronous, so the promotions (and with them
the best trial) are those of the sequential schedule.

Per-trial checkpoints: with `checkpoint_dir`, each trial's trainer state
(`trainer.state_dict()`) is saved with its loss and time history after
every rung, one atomic `CheckpointManager.save`, and the sweep ledger
(configs, losses, epochs, alive flags, promotions applied) is written as
JSON; a killed sweep resumes from the last completed rung, restoring
trainer states instead of retraining. A trainer whose `model` is None is
built lazily on its first fit: its init shape is recorded beside the
checkpoint so that a resumed sweep can build it before restoring.

The reference's post-hoc metric swap (loss <-> time_this_iter_s,
scripts/train.py:142-143) is not reproduced: the best trial is selected by
loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import os
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Trial:
    config: dict
    trainer: Any = None
    losses: list = dataclasses.field(default_factory=list)
    epoch_times: list = dataclasses.field(default_factory=list)
    epochs_done: int = 0
    alive: bool = True
    device_idx: int = 0
    rung_windows: list = dataclasses.field(default_factory=list)  # (t0, t1, dev)

    @property
    def last_loss(self) -> float:
        return self.losses[-1] if self.losses else float("inf")


def sample_configs(space: dict[str, Sequence], num_samples: int, seed: int = 0):
    """Random search over a {name: choices} space (tune.choice equivalent);
    the JAX package's draws, config for config, for a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_samples):
        out.append({k: v[rng.integers(len(v))] for k, v in space.items()})
    return out


def _rung_ladder(grace_period: int, reduction_factor: int, max_t: int) -> list[int]:
    # grace, grace*rf, grace*rf^2, ..., capped at (and always including)
    # max_t: survivors of the last promotion train to max_t, as
    # ASHAScheduler's max_t does
    rungs: list[int] = []
    budget = grace_period
    while budget < max_t:
        rungs.append(budget)
        budget *= reduction_factor
    rungs.append(max_t)
    return rungs


def _listify(x):
    """JSON-encode config values, tagging tuples so the round-trip keeps
    types (a plain list comes back as a list)."""
    if isinstance(x, tuple):
        return {"__tuple__": [_listify(v) for v in x]}
    if isinstance(x, list):
        return [_listify(v) for v in x]
    return x


def _tuplify(x):
    if isinstance(x, dict) and set(x) == {"__tuple__"}:
        return tuple(_tuplify(v) for v in x["__tuple__"])
    if isinstance(x, list):
        return [_tuplify(v) for v in x]
    return x


def _sweep_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "sweep.json")


def _save_sweep(checkpoint_dir: str, trials: list[Trial], rungs_done: int) -> None:
    state = {
        "rungs_done": rungs_done,  # promotions applied; guards rung replay
        "trials": [
            {
                "config": {k: _listify(v) for k, v in t.config.items()},
                "losses": t.losses,
                "epoch_times": t.epoch_times,
                "epochs_done": t.epochs_done,
                "alive": t.alive,
            }
            for t in trials
        ],
    }
    tmp = _sweep_path(checkpoint_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, _sweep_path(checkpoint_dir))


def _load_sweep(checkpoint_dir: str) -> tuple[list[Trial], int] | None:
    path = _sweep_path(checkpoint_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    if isinstance(state, list):  # the JAX package's first ledger: a bare trial list
        state = {"trials": state, "rungs_done": 0}
    trials = []
    for s in state["trials"]:
        trials.append(
            Trial(
                config={k: _tuplify(v) for k, v in s["config"].items()},
                losses=list(s["losses"]),
                epoch_times=list(s["epoch_times"]),
                epochs_done=int(s["epochs_done"]),
                alive=bool(s["alive"]),
            )
        )
    return trials, int(state.get("rungs_done", 0))


def _trial_ckpt_dir(checkpoint_dir: str, i: int) -> str:
    return os.path.join(checkpoint_dir, f"trial_{i:03d}")


def _has_state(trainer) -> bool:
    """A trainer with state to checkpoint: it has `state_dict` and is built
    (a lazy trainer's `model` is None until its first fit)."""
    return hasattr(trainer, "state_dict") and getattr(trainer, "model", None) is not None


def _save_trial_state(checkpoint_dir: str, i: int, trial: Trial) -> None:
    """One atomic save per rung holding the trainer state AND the trial's
    loss and time history: the restored bookkeeping can never be ahead of
    or behind the restored parameters."""
    if not _has_state(trial.trainer):
        return
    from .checkpoint import CheckpointManager

    d = _trial_ckpt_dir(checkpoint_dir, i)
    mgr = CheckpointManager(d, max_to_keep=1)
    if mgr.latest_step() != trial.epochs_done:
        mgr.save(trial.epochs_done, {
            "state": trial.trainer.state_dict(),
            "losses": list(trial.losses),
            "epoch_times": list(trial.epoch_times),
        })
        # a resumed sweep restores into freshly built trainers, whose model
        # is built lazily on the first fit: record the init shape so that
        # _restore_trial_state can build it first
        shape = getattr(trial.trainer, "_init_shape", None)
        if shape is not None:
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump({"init_shape": list(shape)}, f)


def _restore_trial_state(checkpoint_dir: str, i: int, trial: Trial) -> bool:
    """Restore a trainer's state and loss history from the trial's
    directory; False when no checkpoint exists (the trial retrains from
    scratch). The checkpoint is the one source of truth for the trial's
    progress: the sweep ledger may disagree after a crash, and is
    overridden here."""
    from .checkpoint import CheckpointManager

    d = _trial_ckpt_dir(checkpoint_dir, i)
    if not os.path.isdir(d):
        return False
    mgr = CheckpointManager(d, max_to_keep=1)
    step = mgr.latest_step()
    if step is None:
        return False
    if getattr(trial.trainer, "model", None) is None:
        # a freshly built lazy trainer: build its model from the recorded
        # init shape before loading into it
        meta_path = os.path.join(d, "meta.json")
        if not os.path.isfile(meta_path) or not hasattr(trial.trainer, "init_state"):
            raise ValueError(
                f"cannot restore trial {i}: the trainer has no built state and no "
                f"recorded init shape exists in {d}; initialize the trainer's state "
                "before resuming, or delete the trial directory to retrain from scratch"
            )
        with open(meta_path) as f:
            trial.trainer.init_state(tuple(json.load(f)["init_shape"]))
    try:
        out = mgr.restore(step)
        trial.trainer.load_state_dict(out["state"])
        losses, epoch_times = out["losses"], out["epoch_times"]
    except (KeyError, TypeError, RuntimeError) as e:
        raise ValueError(
            f"incompatible trial checkpoint format in {d}; delete the trial directory "
            "to retrain this trial from scratch"
        ) from e
    trial.epochs_done = int(step)
    trial.losses = [float(x) for x in losses[: int(step)]]
    trial.epoch_times = [float(x) for x in epoch_times[: int(step)]]
    return True


def _on_device(dev):
    """The worker thread's current CUDA device (a no-op for the CPU)."""
    dev = torch.device(dev)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def run_asha(
    make_trainer: Callable,
    train_epoch: Callable[[Any], float],
    space: dict[str, Sequence],
    num_samples: int = 50,
    max_t: int = 3,
    grace_period: int = 1,
    reduction_factor: int = 2,
    seed: int = 0,
    log: Callable[[str], None] = print,
    devices: Sequence | None = None,
    checkpoint_dir: str | None = None,
) -> Trial:
    """Run the search; returns the best Trial (min final loss).

    make_trainer(config) or make_trainer(config, mesh) -> trainer object;
    train_epoch(trainer) -> loss. With `devices`, trials are pinned one per
    device (sticky) and each device's trials run on their own worker thread
    on a one-device mesh. With `checkpoint_dir`, the sweep checkpoints after
    every rung and resumes from an existing sweep.json.
    """
    if reduction_factor < 2:  # rf <= 1 makes the rung ladder non-terminating
        raise ValueError(f"reduction_factor must be >= 2, got {reduction_factor}")
    if grace_period < 1 or max_t < grace_period:
        raise ValueError(
            f"need 1 <= grace_period <= max_t, got {grace_period}/{max_t}"
        )
    wants_mesh = len(inspect.signature(make_trainer).parameters) >= 2

    def build(trial: Trial):
        if devices is not None and wants_mesh:
            from ..parallel.mesh import make_mesh

            dev = devices[trial.device_idx]
            trial.trainer = make_trainer(trial.config, make_mesh([dev]))
        else:
            trial.trainer = make_trainer(trial.config)

    trials, rungs_done = None, 0
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        loaded = _load_sweep(checkpoint_dir)
        if loaded is not None:
            trials, rungs_done = loaded
            log(f"[asha] resuming sweep from {checkpoint_dir} "
                f"({sum(t.alive for t in trials)} alive trials, "
                f"{rungs_done} rungs done)")
    if trials is None:
        trials = [Trial(config=c) for c in sample_configs(space, num_samples, seed)]
    n_dev = len(devices) if devices else 1
    for i, t in enumerate(trials):
        t.device_idx = i % n_dev

    rungs = _rung_ladder(grace_period, reduction_factor, max_t)

    def run_trial_to(i: int, t: Trial, rung_budget: int) -> None:
        if t.trainer is None:
            build(t)
            if checkpoint_dir is not None and t.epochs_done > 0:
                if not _restore_trial_state(checkpoint_dir, i, t):
                    # checkpoint lost: retrain from scratch to the same rung
                    t.losses, t.epoch_times, t.epochs_done = [], [], 0
        t0 = time.time()
        while t.epochs_done < rung_budget:
            te = time.time()
            loss = float(train_epoch(t.trainer))
            t.epoch_times.append(time.time() - te)
            t.losses.append(loss)
            t.epochs_done += 1
        t.rung_windows.append((t0, time.time(), t.device_idx))
        if checkpoint_dir is not None:
            _save_trial_state(checkpoint_dir, i, t)
        log(
            f"[asha] trial {i} rung {rung_budget} dev {t.device_idx}: "
            f"loss={t.last_loss:.5f} config={t.config}"
        )

    for rung_i, rung_budget in enumerate(rungs):
        if rung_i < rungs_done:
            continue  # this rung's training AND promotion already applied
        todo = [(i, t) for i, t in enumerate(trials) if t.alive]
        if not todo:
            break
        if n_dev > 1:
            # one worker per device; each runs its own trials sequentially
            by_dev: dict[int, list] = {}
            for i, t in todo:
                by_dev.setdefault(t.device_idx, []).append((i, t))
            errors: list[BaseException] = []

            def worker(dev, items):
                try:
                    with _on_device(dev):
                        for i, t in items:
                            run_trial_to(i, t, rung_budget)
                except BaseException as e:  # re-raised after the join
                    errors.append(e)

            threads = [
                threading.Thread(target=worker, args=(devices[d], items))
                for d, items in by_dev.items()
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            if checkpoint_dir is not None:
                _save_sweep(checkpoint_dir, trials, rungs_done)
            if errors:
                raise errors[0]
        else:
            try:
                for i, t in todo:
                    run_trial_to(i, t, rung_budget)
            finally:
                if checkpoint_dir is not None:
                    _save_sweep(checkpoint_dir, trials, rungs_done)
        if rung_i == len(rungs) - 1:
            break  # final rung: no further pruning
        # promote the top 1/rf of the alive trials; the pruned alive flags
        # and the rung counter land in ONE atomic ledger write, so a resume
        # either replays the whole promotion or skips the whole rung: it can
        # never re-prune an already promoted survivor set
        alive = [t for t in trials if t.alive]
        alive.sort(key=lambda t: t.last_loss)
        keep = max(1, len(alive) // reduction_factor)
        for t in alive[keep:]:
            t.alive = False
            t.trainer = None  # free device memory
        rungs_done = rung_i + 1
        if checkpoint_dir is not None:
            _save_sweep(checkpoint_dir, trials, rungs_done)

    finished = [t for t in trials if t.losses]
    best = min(finished, key=lambda t: t.last_loss)
    log(f"Best trial config: {best.config}")
    log(f"Best trial final validation loss: {best.last_loss}")
    return best
