from .checkpoint import load_torch_checkpoint, read_state_dict
from .encoders import CNNEncoder, ResNetEncoder, create_model, param_count
from .resnet import BasicBlock, BatchNorm, ResNetCore, cross_rank_statistics, frozen_statistics
from .unet import UNet, create_unet
from .weights import state_dict_from_jax

__all__ = [
    "BasicBlock",
    "BatchNorm",
    "CNNEncoder",
    "ResNetCore",
    "ResNetEncoder",
    "UNet",
    "create_model",
    "create_unet",
    "cross_rank_statistics",
    "frozen_statistics",
    "load_torch_checkpoint",
    "param_count",
    "read_state_dict",
    "state_dict_from_jax",
]
