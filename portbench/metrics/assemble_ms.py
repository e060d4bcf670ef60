"""assemble_ms.<cell kind>: host milliseconds inside the program's spans
`crw.assemble.*` (a line's pixel map from its pass maps: to pixels,
correction splices, reverse unflip, merge; portbench/spans.py), per
request of the traced slice."""

from portbench import spans


def read(trace, cell):
    s = spans.host_seconds(trace, "crw.assemble.")
    if s is None or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
