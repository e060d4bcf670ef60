"""unet_fwd_ms.<cell kind>: device milliseconds of the kernels, copies and
sets that belong to the program's spans `crw.unet.forward` (the UNet's
forward) and `crw.unet.up` (the decoder's upsample, pad and concat, inside
the forward; portbench/spans.py), per step of the traced slice."""

from portbench import spans


def read(trace, cell):
    parts = [spans.device_seconds(trace, n) for n in ("crw.unet.forward", "crw.unet.up")]
    s = sum(p for p in parts if p)
    if not s or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
