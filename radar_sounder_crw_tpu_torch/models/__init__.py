from .encoders import CNNEncoder, ResNetEncoder, create_model, param_count
from .resnet import BasicBlock, ResNetCore
from .weights import state_dict_from_jax

__all__ = [
    "BasicBlock",
    "CNNEncoder",
    "ResNetCore",
    "ResNetEncoder",
    "create_model",
    "param_count",
    "state_dict_from_jax",
]
