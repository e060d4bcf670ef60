"""The control of a cell's check: the plain reference computed in the next
precision below the configuration's (TF32 for float32 with TF32 off), or
with a planted fault, put in the program's place and judged by the same
comparison as a run. Its readings set the upper end of each limit
(PERF.md); the benchmark's own runs never run it.

    python3 -m portbench.control --workload <cell> --seed <n> [<n> ...] \
        [--requests 20] [--fault tf32|half_batch]

Prints one JSON line per seed: the numbers compared, with their limits.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness
from portbench.run import ROOT, Ctx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int, nargs="+")
    p.add_argument("--requests", type=int, default=20)
    p.add_argument("--fault", default="tf32", choices=("tf32", "half_batch"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("[portbench] the control needs a CUDA device", file=sys.stderr)
        return 2
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(manifest, args.workload)
    entry = harness.entry_module(cell.mix["entry"])
    for seed in args.seed:
        state = entry.setup(Ctx(cell.config, cell.mix, seed % 2 ** 63, torch.device("cuda")))
        kw = {"fault": args.fault} if args.fault != "tf32" else {}
        numbers = entry.control(state, cell.limits, args.requests, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "check": {n: {"value": v, "limit": lim} for n, v, lim in numbers}}),
              flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
