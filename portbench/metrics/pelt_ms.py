"""pelt_ms.<cell kind>: host milliseconds inside the program's span
`crw.pelt` (change-point detection of one signal on the host;
portbench/spans.py), per request of the traced slice."""

from portbench import spans


def read(trace, cell):
    s = spans.host_seconds(trace, "crw.pelt")
    if s is None or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
