"""port_idle_share.<cell kind>: the share of the traced slice's wall time
in which the device waited while the program was inside one of its own
`crw.*` spans: the idle seconds that `Spans.idle_by_span` gives to any span
(portbench/spans.py), on the busy intervals `idle_share` reads. So
`idle_share - port_idle_share` is the idle time outside the program, in
the harness's own code.

Reading it also prints one line to standard error: the slice's idle
seconds by innermost `crw.*` span (the eight largest, then "none"), its
device seconds by owning span (the eight largest; "-" for no span), and
the device events linked to no host operator (`Spans.unlinked`)."""

import sys

from portbench import spans


def _top(items, n=8):
    return sorted(items, key=lambda kv: -kv[1])[:n]


def read(trace, cell):
    if trace.busy_s == 0:
        return None
    found = spans.of(trace)
    if not found.spans:
        return None
    idle = found.idle_by_span(trace.busy)
    port = [(n, s) for n, s in idle.items() if n != "none"]
    shown = _top(port) + [("none", idle.get("none", 0.0))]
    device = _top((n or "-", s) for n, s in found.device_s.items())
    print("[portbench] idle s by span: " + ", ".join(f"{n} {s:.6f}" for n, s in shown)
          + "; device s by span: " + ", ".join(f"{n} {s:.6f}" for n, s in device)
          + f"; unlinked device events {found.unlinked}", file=sys.stderr)
    return 100.0 * sum(s for _, s in port) / trace.window_s
