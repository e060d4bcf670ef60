from .checkpoint import CheckpointManager, save_encoder_torch
from .crw_trainer import CRWTrainConfig, CRWTrainer, make_crw_train_step
from .tune import run_asha, sample_configs
from .unet_trainer import UNetTrainConfig, UNetTrainer, train_test_split, unfold_strips

__all__ = [
    "CRWTrainConfig",
    "CRWTrainer",
    "CheckpointManager",
    "UNetTrainConfig",
    "UNetTrainer",
    "make_crw_train_step",
    "run_asha",
    "sample_configs",
    "save_encoder_torch",
    "train_test_split",
    "unfold_strips",
]
