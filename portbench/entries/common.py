"""What the drivers share: seeds drawn from the run's seed, the port's
encoder loaded with the benchmark's weights, its propagation pipeline, the
reference's embeddings, and the float32 settings of either side."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import weights
from portbench.reference import resnet


class State:
    """An entry's run state; `log` holds one dict of work counts per request."""

    def __init__(self, **kw):
        self.log: list[dict] = []
        self.__dict__.update(kw)


def geometry(config: dict):
    """(T, N, h, w, oh, ow) of the configuration's inference windows."""
    T = config["seq_length"]
    (h, w), (oh, ow) = config["patch"], config["overlap"]
    return T, (config["rows"] - oh) // (h - oh), h, w, oh, ow


def child_seeds(seed: int, n: int) -> list[int]:
    """n independent 63-bit seeds from the run's seed."""
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(n, dtype=np.uint64)
            % (2 ** 63)]


@contextlib.contextmanager
def tf32(enabled: bool):
    """Float32 products and convolutions in TF32 (enabled) or in full
    float32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def program_encoder(config: dict, sd: dict, device):
    """The port's encoder (`create_model`) with the benchmark's weights
    loaded strictly, in eval mode, the configuration's float32 settings on."""
    from radar_sounder_crw_tpu_torch.models import create_model
    from radar_sounder_crw_tpu_torch.utils import parity_mode

    if config["dtype"] != "float32" or config["tf32"]:
        raise ValueError("the drivers run the float32 configurations with TF32 off")
    parity_mode()
    model = create_model(config["model"], config["pos_embed"], device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def pipeline(config: dict, model, device, cache_embeddings: bool):
    from radar_sounder_crw_tpu_torch.infer import PropagationPipeline
    from radar_sounder_crw_tpu_torch.ops import LabelPropConfig

    p = config["propagation"]
    return PropagationPipeline(
        model, LabelPropConfig(p["cxt_size"], p["radius"], p["temperature"], p["knn"]),
        config["nclasses"], use_pos_embed=config["pos_embed"],
        bn_train_mode=config["bn_train_mode"], xent_tau=config["xent_tau"],
        pelt_pen=config["pelt_pen"], cache_embeddings=cache_embeddings, device=device)


def make_weights(config: dict, seed: int, device, rg) -> dict:
    """The encoder's weights from the seed, BatchNorm calibrated on rg (H, W)."""
    sd = weights.state_dict(seed, device, embed_dim=config["embed_dim"])
    with tf32(False):
        return weights.calibrate(sd, rg, config["patch"], config["overlap"], seed)


def launches() -> int:
    """The port's count of propagation kernel launches so far."""
    from radar_sounder_crw_tpu_torch.ops import labelprop_cuda

    return int(sum(labelprop_cuda.launches.values()))


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(state, *names) -> None:
    """Drop the program's objects and their device memory before the
    reference runs."""
    for n in names:
        if hasattr(state, n):
            delattr(state, n)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_embed(sd: dict, patches: torch.Tensor, precise: bool = True,
                    block: int = 65536) -> torch.Tensor:
    """The reference's normalised embeddings of `patches`, in full float32
    (precise) or in TF32 (the control)."""
    with tf32(not precise):
        return resnet.embed(sd, patches, block)


def prop_args(config: dict) -> dict:
    p = config["propagation"]
    return dict(nclasses=config["nclasses"], cxt=p["cxt_size"], radius=p["radius"],
                temperature=p["temperature"], knn=p["knn"])
