from .checkpoint import load_torch_checkpoint, read_state_dict
from .encoders import CNNEncoder, ResNetEncoder, create_model, param_count
from .resnet import BasicBlock, ResNetCore
from .weights import state_dict_from_jax

__all__ = [
    "BasicBlock",
    "CNNEncoder",
    "ResNetCore",
    "ResNetEncoder",
    "create_model",
    "load_torch_checkpoint",
    "param_count",
    "read_state_dict",
    "state_dict_from_jax",
]
