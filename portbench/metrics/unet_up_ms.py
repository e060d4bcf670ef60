"""unet_up_ms.<cell kind>: device milliseconds of the kernels, copies and
sets that belong to the program's span `crw.unet.up` (the decoder's
upsample, pad and concat in the forward; their gradients run in the
backward; portbench/spans.py), per step of the traced slice."""

from portbench import spans


def read(trace, cell):
    s = spans.device_seconds(trace, "crw.unet.up")
    if not s or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
