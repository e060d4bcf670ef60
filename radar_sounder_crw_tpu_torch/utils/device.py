"""Device resolution and float32 parity settings.

Every entry point of the package runs on the GPU unless the caller asks for
the CPU: `resolve_device(None)` is `cuda`, and it raises when no CUDA device
is present instead of quietly running elsewhere.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda. A CUDA device that is not available raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "on the CPU"
        )
    return dev


def parity_mode() -> None:
    """Run float32 matmuls and convolutions in full float32 (TF32 off).

    PyTorch's default runs cuDNN float32 convolutions in TF32, which alone
    moves the encoder's embeddings by ~1e-3 from a float32 reference; the JAX
    package runs its float32 products at Precision.HIGHEST
    (radar_sounder_crw_tpu/ops/labelprop.py, `_prop_step`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
