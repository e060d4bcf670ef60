"""idle_share.<cell kind>: the share of the traced slice's wall time in
which no kernel, copy or set ran on the device."""


def read(trace, cell):
    if trace.busy_s == 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
