"""PyTorch/CUDA port of radar_sounder_crw_tpu for NVIDIA Hopper GPUs.

Seed->map label propagation and full-survey inference: encoders (models/),
the horizontality metric, PELT and ring-buffer top-k propagation (ops/),
radargram datasets, the registry and device-side windowing (data/), and the
pipeline with correction and bidirectional merge (infer/). Propagation runs
as hand-written CUDA kernels on the GPU (csrc/prop_step.cu per frame,
csrc/prop_seq.cu per survey pass) and as plain PyTorch on the CPU.
Training: the CRW loss (ops/crw.py), the UNet baseline (models/unet.py) and
their trainers with checkpoints (train/). The command lines are under cli/.
Every entry point runs on `cuda` unless the caller passes device='cpu'.
"""
