"""The port's ASHA tuner (radar_sounder_crw_tpu_torch/train/tune.py) against
the JAX package's (radar_sounder_crw_tpu/train/tune.py), with fake
trainers: the draws, the rung ladder, the ledger encoding, the schedule
(promotions, alive flags, best trial, losses) sequential and one worker
thread per device, and the ports of tests/test_tune_and_unet.py's resume
checks on the port's torch checkpoints. Exact equality throughout: the
fakes' losses are functions of their config and epoch count.
"""

import json
import time

import jax
import pytest
import torch

import radar_sounder_crw_tpu.train.tune as jax_tune
import radar_sounder_crw_tpu_torch.train.tune as tune
from radar_sounder_crw_tpu_torch.train import run_asha, sample_configs

SPACE = {
    "batch_size": [16, 8],
    "lr": [1e-2, 1e-3, 1e-4, 1e-5],
    "patch_size": [(32, 32), (16, 16)],
    "dims": [[16, 32], [8]],
    "pos_embed": [False, True],
}


@pytest.mark.parametrize("seed", [0, 1, 11, 12345])
def test_sample_configs_equal_jax(seed):
    got = sample_configs(SPACE, 9, seed=seed)
    assert got == jax_tune.sample_configs(SPACE, 9, seed=seed)
    assert got == sample_configs(SPACE, 9, seed=seed)
    assert all(c[k] in SPACE[k] for c in got for k in SPACE)


@pytest.mark.parametrize("grace,rf,max_t", [(1, 2, 3), (1, 2, 4), (1, 3, 9), (2, 2, 9), (3, 2, 3),
                                            (1, 4, 100)])
def test_rung_ladder_equal_jax(grace, rf, max_t):
    got = tune._rung_ladder(grace, rf, max_t)
    assert got == jax_tune._rung_ladder(grace, rf, max_t)
    assert got[0] == grace and got[-1] == max_t


def test_ledger_values_round_trip_like_jax():
    """Tuples and lists survive the JSON ledger with their types, encoded as
    the JAX package encodes them."""
    cfg = {"patch": (16, 16), "dims": [16, 32], "nested": ([1, 2], (3, 4)), "lr": 1e-3,
           "name": "x"}
    encoded = {k: tune._listify(v) for k, v in cfg.items()}
    assert encoded == {k: jax_tune._listify(v) for k, v in cfg.items()}
    back = {k: tune._tuplify(v) for k, v in json.loads(json.dumps(encoded)).items()}
    assert back == cfg
    assert isinstance(back["patch"], tuple) and isinstance(back["dims"], list)
    assert isinstance(back["nested"][0], list) and isinstance(back["nested"][1], tuple)


class QualityTrainer:
    """A fake trainer whose loss is its config's quality plus a decaying
    term of its epoch count; its state is a tensor dict."""

    def __init__(self, config, mesh=None):
        self.q = float(config["quality"])
        self.mesh = mesh
        self.model = {"epochs": torch.zeros((), dtype=torch.int64)}

    def state_dict(self):
        return {"epochs": self.model["epochs"].clone()}

    def load_state_dict(self, state):
        self.model = {"epochs": state["epochs"].clone()}


def quality_epoch(trainer, sleep=0.0):
    time.sleep(sleep)  # releases the interpreter lock, as kernels do
    trainer.model["epochs"] += 1
    return trainer.q + 1.0 / float(trainer.model["epochs"] + 1)


def _recorded(module, *args, **kwargs):
    """`module.run_asha` returning (best, every Trial it created)."""
    created = []
    orig = module.Trial

    class Recording(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            created.append(self)

    module.Trial = Recording
    try:
        best = module.run_asha(*args, **kwargs)
    finally:
        module.Trial = orig
    return best, created


def _schedule(trials):
    return [(t.config, t.losses, t.epochs_done, t.alive) for t in trials]


def test_run_asha_equals_jax_sequential_and_threaded():
    """Same fakes, same schedule in both packages: promotions, alive flags,
    losses, the best trial; the port's devices=[cpu, cpu] equals its
    sequential run and the JAX one on two devices, its trials pinned to
    one-device meshes on two worker threads that overlap in time."""
    space = {"quality": [1.0, 2.0, 3.0, 4.0, 5.0]}
    kw = dict(num_samples=8, max_t=4, grace_period=1, reduction_factor=2, seed=0,
              log=lambda s: None)
    want, want_trials = _recorded(jax_tune, QualityTrainer, quality_epoch, space, **kw)
    seq, seq_trials = _recorded(tune, QualityTrainer, quality_epoch, space, **kw)
    assert _schedule(seq_trials) == _schedule(want_trials)
    assert (seq.config, seq.losses) == (want.config, want.losses)
    assert seq.config["quality"] == 1.0 and seq.epochs_done == 4
    assert any(not t.alive for t in seq_trials)

    devices = [torch.device("cpu"), torch.device("cpu")]
    par, par_trials = _recorded(tune, QualityTrainer, lambda t: quality_epoch(t, 0.05), space,
                                devices=devices, **kw)
    jax_par, jax_par_trials = _recorded(jax_tune, QualityTrainer,
                                        lambda t: quality_epoch(t, 0.0),
                                        space, devices=jax.devices()[:2], **kw)
    assert _schedule(par_trials) == _schedule(seq_trials) == _schedule(jax_par_trials)
    assert (par.config, par.losses) == (seq.config, seq.losses)
    assert par.trainer.mesh.device == torch.device("cpu") and par.trainer.mesh.group is None
    windows = [w for t in par_trials for w in t.rung_windows]
    assert {d for _, _, d in windows} == {0, 1}
    assert any(d1 != d2 and a1 < b2 and a2 < b1
               for i, (a1, b1, d1) in enumerate(windows) for (a2, b2, d2) in windows[i + 1:])


def test_resume_after_kill_trains_nothing_twice(tmp_path):
    """A sweep killed in its first rung resumes from the per-trial torch
    checkpoints: checkpointed epochs are not retrained, the result equals a
    sweep that was never killed, and resuming a finished sweep trains
    nothing."""
    space = {"quality": [1.0, 2.0, 3.0, 4.0]}
    calls = {"n": 0}

    def epoch(trainer):
        calls["n"] += 1
        return quality_epoch(trainer)

    def crashing_epoch(trainer):
        if calls["n"] >= 5:
            raise RuntimeError("simulated kill")
        return epoch(trainer)

    kw = dict(space=space, num_samples=6, max_t=4, grace_period=1, reduction_factor=2, seed=1,
              log=lambda s: None)
    ckpt = str(tmp_path / "sweep")
    with pytest.raises(RuntimeError, match="simulated kill"):
        run_asha(QualityTrainer, crashing_epoch, checkpoint_dir=ckpt, **kw)
    assert calls["n"] == 5
    best = run_asha(QualityTrainer, epoch, checkpoint_dir=ckpt, **kw)
    resumed = calls["n"] - 5

    calls["n"] = 0
    control = run_asha(QualityTrainer, epoch, checkpoint_dir=str(tmp_path / "control"), **kw)
    assert (best.config, best.losses) == (control.config, control.losses)
    assert best.config["quality"] == 1.0 and best.epochs_done == 4
    assert resumed == calls["n"] - 5  # the 5 checkpointed epochs were restored
    assert int(best.trainer.model["epochs"]) == 4

    calls["n"] = 0
    again = run_asha(QualityTrainer, epoch, checkpoint_dir=ckpt, **kw)
    assert calls["n"] == 0
    assert (again.config, again.losses) == (best.config, best.losses)


def test_resume_builds_a_lazy_trainer_first(tmp_path):
    """A trainer built lazily on its first fit (model None, as CRWTrainer
    and UNetTrainer before init_state) is built from the recorded init
    shape before its checkpoint loads; without that record it raises."""

    class LazyTrainer:
        def __init__(self, config):
            self.q = float(config["quality"])
            self.model = None

        def init_state(self, shape):
            self._init_shape = tuple(shape)
            self.model = {"epochs": torch.zeros((), dtype=torch.int64)}

        state_dict = QualityTrainer.state_dict
        load_state_dict = QualityTrainer.load_state_dict

    calls = {"n": 0}

    def epoch(trainer):
        if trainer.model is None:
            trainer.init_state((4, 5))
        calls["n"] += 1
        return quality_epoch(trainer)

    def crashing_epoch(trainer):
        if calls["n"] >= 4:
            raise RuntimeError("simulated kill")
        return epoch(trainer)

    kw = dict(space={"quality": [1.0, 2.0, 3.0]}, num_samples=4, max_t=3, grace_period=1,
              reduction_factor=2, seed=2, log=lambda s: None,
              checkpoint_dir=str(tmp_path / "sweep"))
    with pytest.raises(RuntimeError, match="simulated kill"):
        run_asha(LazyTrainer, crashing_epoch, **kw)
    best = run_asha(LazyTrainer, epoch, **kw)
    assert best.epochs_done == 3 and int(best.trainer.model["epochs"]) == 3

    meta = tmp_path / "sweep" / "trial_000" / "meta.json"
    assert json.loads(meta.read_text()) == {"init_shape": [4, 5]}
    meta.unlink()
    trial = tune.Trial(config={"quality": 1.0}, trainer=LazyTrainer({"quality": 1.0}))
    with pytest.raises(ValueError, match="no recorded init shape"):
        tune._restore_trial_state(str(tmp_path / "sweep"), 0, trial)


def test_schedule_parameters_are_validated():
    noop = lambda *a, **k: None  # noqa: E731
    with pytest.raises(ValueError, match="reduction_factor"):
        run_asha(noop, noop, {"a": [1]}, reduction_factor=1)
    with pytest.raises(ValueError, match="grace_period"):
        run_asha(noop, noop, {"a": [1]}, grace_period=0)
    with pytest.raises(ValueError, match="grace_period"):
        run_asha(noop, noop, {"a": [1]}, grace_period=5, max_t=3)


def test_resume_after_a_promotion_does_not_prune_again(tmp_path):
    """Killed in rung 2, after rung 1's promotion was written: the resume
    goes on with both survivors instead of promoting again."""
    calls = {"n": 0}

    def epoch(trainer):
        calls["n"] += 1
        return trainer.q

    def crashing_epoch(trainer):
        if calls["n"] >= 5:  # rungs [1, 2, 4]: 4 epochs in rung 1, then 4 -> 2
            raise RuntimeError("simulated kill")
        return epoch(trainer)

    kw = dict(space={"quality": [1.0, 2.0, 3.0, 4.0]}, num_samples=4, max_t=4, grace_period=1,
              reduction_factor=2, seed=3, log=lambda s: None,
              checkpoint_dir=str(tmp_path / "sweep"))
    with pytest.raises(RuntimeError, match="simulated kill"):
        run_asha(QualityTrainer, crashing_epoch, **kw)
    best, trials = _recorded(tune, QualityTrainer, epoch, **kw)
    assert len([t for t in trials if t.epochs_done >= 2]) == 2, _schedule(trials)
    assert best.epochs_done == 4
    assert best.config["quality"] == min(t.config["quality"] for t in trials)


def test_trial_checkpoint_bundles_the_loss_history(tmp_path):
    """One save holds the trainer state with the loss and time history: a
    restore over a stale ledger recovers both, aligned; a payload of
    another format raises ValueError."""
    trainer = QualityTrainer({"quality": 1.0})
    trainer.model["epochs"] += 7
    t = tune.Trial(config={"quality": 1.0}, trainer=trainer, losses=[0.5, 0.25],
                   epoch_times=[1.0, 2.0], epochs_done=2)
    tune._save_trial_state(str(tmp_path), 0, t)

    stale = tune.Trial(config={"quality": 1.0}, trainer=QualityTrainer({"quality": 1.0}),
                       losses=[0.5], epoch_times=[1.0], epochs_done=1)
    assert tune._restore_trial_state(str(tmp_path), 0, stale)
    assert (stale.epochs_done, stale.losses, stale.epoch_times) == (2, [0.5, 0.25], [1.0, 2.0])
    assert int(stale.trainer.model["epochs"]) == 7
    assert not tune._restore_trial_state(str(tmp_path), 1, stale)

    from radar_sounder_crw_tpu_torch.train import CheckpointManager

    CheckpointManager(tmp_path / "trial_002").save(3, {"epochs": torch.zeros(())})
    with pytest.raises(ValueError, match="incompatible trial checkpoint"):
        tune._restore_trial_state(str(tmp_path), 2, stale)


def test_sweep_ledger_matches_jax_keys(tmp_path):
    """sweep.json keeps the JAX package's keys and tagging, and either
    package reads the other's ledger."""
    trials = [tune.Trial(config={"patch_size": (32, 32), "lr": 1e-3}, losses=[0.5],
                         epoch_times=[1.5], epochs_done=1, alive=False)]
    (tmp_path / "port").mkdir()
    tune._save_sweep(str(tmp_path / "port"), trials, 1)
    jax_tune._save_sweep(str(tmp_path), trials, 1)
    port = json.loads((tmp_path / "port" / "sweep.json").read_text())
    assert port == json.loads((tmp_path / "sweep.json").read_text())
    back, rungs = tune._load_sweep(str(tmp_path))
    assert rungs == 1 and back[0].config == trials[0].config and not back[0].alive
