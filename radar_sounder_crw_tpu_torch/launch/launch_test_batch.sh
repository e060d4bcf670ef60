#!/usr/bin/env bash
# Grid sweep of the PyTorch/CUDA port over label-prop radius / temperature /
# knn (counterpart of scripts/launch/launch_test_batch.sh: the same 27 runs
# in the same order). Runs `python3`, not `python`: a machine with the CUDA
# build of PyTorch may have no `python` command.
set -euo pipefail
cd "$(dirname "$0")/../.."

for radius in 5 10 20; do
  for temp in 0.01 0.1 1.0; do
    for knn in 5 10 20; do
      echo "=== radius=${radius} temp=${temp} knn=${knn} ==="
      python3 -m radar_sounder_crw_tpu_torch.cli.test_all \
        --radius "${radius}" --temp "${temp}" --knn "${knn}" --no_plots "$@"
    done
  done
done
