"""frame_host_us.<cell kind>: host microseconds inside the program's span
`crw.frames` (the per-frame propagation loop; portbench/spans.py) per
propagation kernel launch, from the program's counter
(ops/labelprop_cuda.launches) over the traced slice."""

from portbench import spans


def read(trace, cell):
    n = trace.counters.get("prop_launches")
    s = spans.host_seconds(trace, "crw.frames")
    if s is None or not n:
        return None
    return 1e6 * s / n
