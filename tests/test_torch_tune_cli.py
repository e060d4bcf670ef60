"""The port's `cli.train --tune` (tune_main) against scripts/train.py's on the
same tiny monkeypatched dataset and search space, as
tests/test_train_cli.py drives the script: both pick the same best config,
and each trial's epoch losses agree within relative 2e-4, the CNN
trajectory tolerance of tests/test_torch_train.py. The port's trainers
start from the JAX trainers' init (the flax variables through
`state_dict_from_jax`), and both sides shuffle by (seed, epoch). That
tolerance was set over 12 steps at lr 1e-3, so the sweep stays within
both: lr at most 1e-3 and 4 steps an epoch, 12 for a trial that reaches
max_t. Past them the two packages' trajectories separate as any two
backends' do (measured here: 1e-3 within 12 steps at lr 1e-2, 4e-4 after
36 steps at lr 1e-3). Then a
rerun of the port's sweep over its --tune_ckpt_dir trains nothing and
reports the same best trial.
"""

import types

import jax
import numpy as np

import radar_sounder_crw_tpu.data as jax_data
import radar_sounder_crw_tpu.train.tune as jax_tune
import radar_sounder_crw_tpu_torch.data as port_data
import radar_sounder_crw_tpu_torch.train.tune as port_tune
from radar_sounder_crw_tpu.parallel import make_mesh as jax_make_mesh
from radar_sounder_crw_tpu.train import CRWTrainConfig as JaxConfig
from radar_sounder_crw_tpu.train import CRWTrainer as JaxTrainer
from radar_sounder_crw_tpu_torch.cli import train as port_train
from radar_sounder_crw_tpu_torch.models import state_dict_from_jax
from radar_sounder_crw_tpu_torch.train import CRWTrainer
from test_torch_train_cli import jax_script
from _torch_threads import few_torch_threads  # noqa: F401 (a fixture)

SPACE = {
    "batch_size": [8],
    "lr": [1e-3, 1e-4],
    "tau": [0.1, 0.05],
    "patch_size": [(16, 16)],
    "overlap": [(8, 0)],
    "pos_embed": [False],
}


def _args(tune_ckpt_dir=None):
    return types.SimpleNamespace(
        tune=True, tune_samples=3, tune_dataset=0, tune_model=0, tune_seq_length=4, seed=11,
        tune_sequential=False, tune_ckpt_dir=tune_ckpt_dir, device="cpu")


def _recorded(module, run):
    """run() with `module.Trial` recording every trial it creates."""
    created, orig = [], module.Trial

    class Recording(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            created.append(self)

    module.Trial = Recording
    try:
        return run(), created
    finally:
        module.Trial = orig


def test_tune_main_matches_the_script(tmp_path, monkeypatch):
    rg, _ = jax_data.synthetic_radargram(H=80, W=240, seed=12)  # 26 windows: 4 steps an epoch
    monkeypatch.setattr(jax_data, "create_dataset", lambda id, length, dim, overlap, full=False,
                        flip=False: jax_data.RGWindows(rg, length=length, dim=dim,
                                                       overlap=overlap))
    monkeypatch.setattr(port_data, "create_dataset", lambda id, length, dim, overlap, full=False,
                        flip=False: port_data.RGWindows(rg, length=length, dim=dim,
                                                        overlap=overlap))
    args = _args()
    want, want_trials = _recorded(jax_tune, lambda: jax_script("train").tune_main(args, SPACE))

    # the port's trainers from the JAX init (seed 11, model 0, one item shape)
    shape = port_data.create_dataset(0, 4, (16, 16), (8, 0))[0].shape
    jt = JaxTrainer(JaxConfig(model=0, seed=11), mesh=jax_make_mesh(jax.devices()[:1]))
    jt.init_state(shape)
    init = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(jt.variables())))
    built = CRWTrainer.init_state

    def init_from_jax(self, item_shape):
        built(self, item_shape)
        self.model.load_state_dict(init, strict=True)

    monkeypatch.setattr(CRWTrainer, "init_state", init_from_jax)
    got, got_trials = _recorded(port_tune, lambda: port_train.tune_main(args, SPACE))

    assert got.config == want.config
    assert [t.config for t in got_trials] == [t.config for t in want_trials]
    assert [t.alive for t in got_trials] == [t.alive for t in want_trials]
    for g, w in zip(got_trials, want_trials):
        assert len(g.losses) == len(w.losses) > 0
        np.testing.assert_allclose(g.losses, w.losses, rtol=2e-4)
    assert np.isfinite(got.last_loss)

    # a rerun over the sweep's checkpoints trains nothing
    ckpt = _args(tune_ckpt_dir=str(tmp_path / "sweep"))
    first = port_train.tune_main(ckpt, SPACE)
    fits = []
    monkeypatch.setattr(CRWTrainer, "fit", lambda self, *a, **k: fits.append(1) or [0.0])
    again = port_train.tune_main(ckpt, SPACE)
    assert fits == []
    assert (again.config, again.losses) == (first.config, first.losses)
    assert first.losses == got.losses
