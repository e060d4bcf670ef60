"""encode_ms.<cell kind>: device milliseconds of the kernels, copies and
sets that belong to the program's span `crw.encode` (the encoder forward
over all patches; portbench/spans.py), per request or step of the traced
slice."""

from portbench import spans


def read(trace, cell):
    s = spans.device_seconds(trace, "crw.encode")
    if not s or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
