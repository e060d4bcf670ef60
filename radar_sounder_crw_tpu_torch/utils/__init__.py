from .device import parity_mode, resolve_device
from .pos_embed import maybe_pos_embed, pos_embed
from .resize import resize_nearest

__all__ = [
    "maybe_pos_embed",
    "parity_mode",
    "pos_embed",
    "resize_nearest",
    "resolve_device",
]
