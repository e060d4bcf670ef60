"""unet_bwd_ms.<cell kind>: device milliseconds of the kernels, copies and
sets that belong to the program's span `crw.unet.backward` (zero_grad and
the UNet step's backward, the autograd engine's launches included;
portbench/spans.py), per step of the traced slice."""

from portbench import spans


def read(trace, cell):
    s = spans.device_seconds(trace, "crw.unet.backward")
    if not s or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
