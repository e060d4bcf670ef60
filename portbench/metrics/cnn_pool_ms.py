"""cnn_pool_ms.<cell kind>: device milliseconds a step of the CNN encoder's
two stride-1 max-pools: the kernels launched under the pools' forward
operator and under their backward operator (which the autograd engine
launches inside `crw.backward`), per step of the traced slice."""

OPS = ("aten::max_pool2d_with_indices", "aten::max_pool2d_with_indices_backward")


def read(trace, cell):
    s = sum(trace.op_device_seconds.get(op, 0.0) for op in OPS)
    if s == 0 or trace.requests == 0:
        return None
    return 1e3 * s / trace.requests
