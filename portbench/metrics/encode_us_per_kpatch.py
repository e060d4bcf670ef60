"""encode_us_per_kpatch.<cell kind>: device microseconds of the kernels,
copies and sets that belong to the program's span `crw.encode` (the encoder
forward; portbench/spans.py) per thousand patches the encoder took in, from
the program's own counter (models/encoders.py `patches`) over the traced
slice. A time per patch, not a share of a peak: cuDNN's FFT and Winograd
convolutions do fewer multiplies than the direct count."""

from portbench import spans


def read(trace, cell):
    n = trace.counters.get("encode_patches")
    if not n:
        return None
    s = spans.device_seconds(trace, "crw.encode")
    if not s:
        return None
    return 1e6 * s / (n / 1e3)
