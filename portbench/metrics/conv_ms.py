"""conv_ms.<cell kind>: device milliseconds of the kernels launched under
the encoder's convolutions (aten::convolution and, in training,
aten::convolution_backward), per request or step of the traced slice."""

OPS = ("aten::convolution", "aten::convolution_backward")


def read(trace, cell):
    s = sum(trace.op_device_seconds.get(op, 0.0) for op in OPS)
    if s == 0 or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
