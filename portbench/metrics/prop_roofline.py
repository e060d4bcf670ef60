"""prop_roofline.<cell kind>: the propagation kernels' share of their
roofline: the least time the chip could take for the propagation calls of
the traced slice (operations at the float32 peak or bytes at the memory
peak, whichever is longer, call by call, arith.py) over the device time of
the prop_step, prop_seq and prop_all kernels."""


def is_prop(name: str) -> bool:
    return "prop_step_" in name or "prop::frames::" in name


def read(trace, cell):
    t = trace.kernel_seconds(is_prop)
    bound = trace.work.get("prop_bound_s", 0.0)
    if t == 0 or bound == 0:
        return None
    return 100.0 * bound / t
