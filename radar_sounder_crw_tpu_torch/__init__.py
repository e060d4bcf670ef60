"""PyTorch/CUDA port of radar_sounder_crw_tpu for NVIDIA Hopper GPUs.

Seed->map label propagation: encoders (models/), the horizontality metric,
PELT and ring-buffer top-k propagation (ops/), and the pipeline (infer/).
The per-frame propagation step runs as a hand-written CUDA kernel
(csrc/prop_step.cu) on the GPU and as plain PyTorch on the CPU. Every entry
point runs on `cuda` unless the caller passes device='cpu'.
"""
