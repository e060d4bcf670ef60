"""Weight bridge: flax variables (as numpy) -> a torch state_dict.

The mapping is that of radar_sounder_crw_tpu/models/torch_import.py
(`export_state_dict`, `_to_torch_name`), copied for the encoders:
  * conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in);
  * BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
    running_mean/running_var (+ a zero `num_batches_tracked`);
  * flax `layerS_B` -> torch `layerS.B`, `downsample_conv`/`downsample_bn` ->
    `downsample.0`/`downsample.1`;
  * the UNet's flat DoubleConv names (`conv1`, `bn1`, `conv2`, `bn2` under
    `inc`, `downK`, `upK`) -> the reference's Sequential indices behind
    `double_conv`, `maxpool_conv.1.double_conv` and `conv.double_conv`;
    `outc` -> `outc.conv`; `upK_up` -> `upK.up`, a transposed-conv kernel
    (kH, kW, in, out) spatially flipped to torch's (in, out, kH, kW).
The port's modules name their submodules the same way, so the result loads
with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


# flax DoubleConv submodule -> index in the reference's nn.Sequential (2 and
# 5 are the parameterless ReLUs)
_DC_IDX_REV = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
_UNET_DC_PARENTS = {"inc", "down1", "down2", "down3", "up1", "up2", "up3"}


def _torch_module_name(path: tuple[str, ...]) -> str:
    parts: list[str] = []
    for m in path:
        if m == "downsample_conv":
            parts += ["downsample", "0"]
        elif m == "downsample_bn":
            parts += ["downsample", "1"]
        elif m.startswith("layer") and "_" in m and m.rsplit("_", 1)[1].isdigit():
            parts += m.rsplit("_", 1)
        elif m in _DC_IDX_REV and parts and parts[-1] in _UNET_DC_PARENTS:
            parent = parts[-1]
            if parent.startswith("down"):
                parts += ["maxpool_conv", "1", "double_conv", _DC_IDX_REV[m]]
            elif parent.startswith("up"):
                parts += ["conv", "double_conv", _DC_IDX_REV[m]]
            else:  # inc
                parts += ["double_conv", _DC_IDX_REV[m]]
        elif m == "outc":
            parts += ["outc", "conv"]
        elif m.startswith("up") and m.endswith("_up"):
            parts += [m[: -len("_up")], "up"]
        else:
            parts.append(m)
    return ".".join(parts)


def state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} nested dicts of arrays -> torch
    state_dict (float32 CPU tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path, coll):
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, path + (key,), coll)
                continue
            arr = np.array(val, dtype=np.float32)  # a writable copy
            if key == "kernel" and arr.ndim == 4 and path and path[-1].endswith("_up"):
                arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))  # transposed conv
            elif key == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr.T
            name = _torch_module_name(path)
            out[f"{name}.{_LEAF[(coll, key)]}"] = torch.from_numpy(np.ascontiguousarray(arr))
            if coll == "batch_stats" and key == "mean":
                out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    walk(variables.get("params", {}), (), "params")
    walk(variables.get("batch_stats", {}), (), "batch_stats")
    return out
