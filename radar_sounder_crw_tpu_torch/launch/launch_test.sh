#!/usr/bin/env bash
# Single evaluation run of the PyTorch/CUDA port (counterpart of
# scripts/launch/launch_test.sh). Runs `python3`, not `python`: a machine
# with the CUDA build of PyTorch may have no `python` command.
set -euo pipefail
cd "$(dirname "$0")/../.."
python3 -m radar_sounder_crw_tpu_torch.cli.test_all "$@"
