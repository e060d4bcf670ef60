#!/usr/bin/env bash
# Grid sweep of the PyTorch/CUDA port over seq_length / lr / tau / overlap
# (counterpart of scripts/launch/launch_train_batch.sh: the same 81 runs in
# the same order, the same output names). Runs `python3`, not `python`: a
# machine with the CUDA build of PyTorch may have no `python` command.
set -euo pipefail
cd "$(dirname "$0")/../.."

for seq_length in 10 20 40; do
  for lr in 1e-2 1e-3 1e-4; do
    for tau in 1e-1 1e-2 1e-3; do
      for overlap in "8 0" "12 0" "14 0"; do
        name="crw_s${seq_length}_lr${lr}_tau${tau}_ov${overlap// /_}"
        echo "=== ${name} ==="
        python3 -m radar_sounder_crw_tpu_torch.cli.train \
          --seq_length "${seq_length}" --lr "${lr}" --tau "${tau}" \
          --overlap ${overlap} --output_name "${name}" "$@"
      done
    done
  done
done
