"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix (BENCHMARK.json names
them), makes the data and the weights from the seed, warms up, drives the
port for `--seconds` in a closed loop, checks what the window produced
against the plain reference in portbench/reference/, and prints one JSON
line last on standard output. With --trace 1 the first `trace_seconds` of
the window (a key of the mix) run under torch.profiler and the line
carries the cell's per-layer metrics instead of its end-to-end ones.
Refuses to run (exit code 2, no result) without as many CUDA devices as
the cell asks for, and exits with code 3 if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import harness  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Ctx:
    """What an entry's set-up is given."""

    config: dict
    mix: dict
    seed: int
    device: object


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    return p.parse_args(argv)


def card_line(torch) -> str:
    """The card's name and count, and what nvidia-smi reads of clocks and power."""
    out = f"device {torch.cuda.get_device_name(0)!r} count {torch.cuda.device_count()}"
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return out + " nvidia-smi: not found"
    q = "name,clocks.sm,clocks.max.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        r = subprocess.run([smi, f"--query-gpu={q}", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return out + f" nvidia-smi [{q}]: " + " | ".join(r.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return out + f" nvidia-smi failed: {e}"


def sum_work(log: list, lo: int, hi: int) -> dict:
    out: dict = {}
    for rec in log[lo:hi]:
        for k, v in rec.items():
            out[k] = out.get(k, 0) + v
    return out


def run(args, *, manifest: dict | None = None, roots=(harness.HERE,), allow_cpu: bool = False,
        t_start: float = T_START) -> dict:
    """One run; returns the result object. allow_cpu lets the tests drive
    a run on the CPU at toy sizes; the command line never sets it."""
    if manifest is None:
        manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(manifest, args.workload, roots)
    chips = next(w["chips"] for w in manifest["workloads"] if w["name"] == args.workload)

    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        device = torch.device("cuda")
        print(f"[portbench] {card_line(torch)}", file=sys.stderr)
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        raise harness.Refused(
            f"needs {chips} CUDA device(s); cuda available: {torch.cuda.is_available()}, "
            f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    on_gpu = device.type == "cuda"

    entry = harness.entry_module(cell.mix["entry"])
    seed = int(args.seed) % (2 ** 63)
    state = entry.setup(Ctx(cell.config, cell.mix, seed, device))
    if on_gpu:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"[portbench] set-up {setup_s:.3f} s", file=sys.stderr)

    trace = None
    if args.trace:
        from portbench import trace as tr

        sliced = min(float(cell.mix.get("trace_seconds", args.seconds)), args.seconds)
        before = entry.counters(state)
        with tr.profiled() as prof:
            with tr.span("window"):
                win = harness.drive(entry, state, sliced)
        after = entry.counters(state)
        counters = {k: after[k] - before[k] for k in after}
        trace = tr.Trace(prof, win.requests, sum_work(state.log, 0, win.requests), counters)
        rest = harness.drive(entry, state, args.seconds - win.seconds, start_index=win.requests) \
            if args.seconds > win.seconds else harness.Window()
        attempted, failed = win.requests + rest.requests, win.failed + rest.failed
    else:
        win = harness.drive(entry, state, args.seconds)
        attempted, failed = win.requests, win.failed
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    lat = sorted(win.latencies) or [0.0]
    print(f"[portbench] requests {attempted} failed {failed}; window {win.seconds:.3f} s, "
          f"{win.requests} requests, latency ms min {lat[0] * 1e3:.3f} median "
          f"{lat[len(lat) // 2] * 1e3:.3f} max {lat[-1] * 1e3:.3f}", file=sys.stderr)

    numbers = entry.check(state, cell.limits)
    correct = failed == 0 and harness.judge(numbers)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.reader(m["name"], roots)(trace, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        reported = cell.mix["reports"]
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] == reported:
                value = harness.statistic(cell.mix["statistic"], win.latencies, win.units,
                                          win.seconds)
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
           "count": chips if on_gpu else 0, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    found = harness.forbidden_modules()
    if found:
        raise harness.Refused(f"JAX or the JAX package was loaded: {found}")
    print(harness.numbers_text(numbers), file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result = run(args)
    except harness.Refused as e:
        print(f"[portbench] refused: {e}", file=sys.stderr)
        return 3 if "JAX" in str(e) else 2
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
