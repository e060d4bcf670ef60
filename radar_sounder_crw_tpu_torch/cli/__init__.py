"""The port's command-line entry points, each run as
`python -m radar_sounder_crw_tpu_torch.cli.<name>`: the scripts of the JAX
package (scripts/<name>.py) with the same flags, defaults and printed
lines, plus `--device` (default cuda). The inference entry points also take
`--kernel` {auto, torch, cuda, cuda_seq, cuda_resident}; `train` (CRW
pretraining) and `test_unet` (the supervised baseline) train."""
