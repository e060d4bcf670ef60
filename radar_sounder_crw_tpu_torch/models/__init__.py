from .checkpoint import load_torch_checkpoint, read_state_dict
from .encoders import CNNEncoder, ResNetEncoder, create_model, param_count
from .fused_bn import FusedBatchNorm, LeanBatchNorm, bn_train
from .resnet import (
    BasicBlock,
    BatchNorm,
    ResNetCore,
    cross_rank_statistics,
    frozen_statistics,
    make_norm,
)
from .unet import UNet, create_unet
from .weights import state_dict_from_jax

__all__ = [
    "BasicBlock",
    "BatchNorm",
    "CNNEncoder",
    "FusedBatchNorm",
    "LeanBatchNorm",
    "ResNetCore",
    "ResNetEncoder",
    "UNet",
    "bn_train",
    "create_model",
    "create_unet",
    "cross_rank_statistics",
    "frozen_statistics",
    "load_torch_checkpoint",
    "make_norm",
    "param_count",
    "read_state_dict",
    "state_dict_from_jax",
]
