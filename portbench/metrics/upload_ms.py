"""upload_ms.<cell kind>: device milliseconds of the copies that belong to
the program's span `crw.upload` (a host-to-device copy of input data: a
window, a line's radargram, a host batch; portbench/spans.py), per request
of the traced slice. None where the program has no such span."""

from portbench import spans


def read(trace, cell):
    s = spans.device_seconds(trace, "crw.upload")
    if not s or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
