"""mfu.<cell kind>: the share of the chip's float32 peak that the traced
slice's completed work used: the operations the yardstick counts for its
requests or steps (arith.py), over the slice's seconds and 67 TFLOP/s."""

from portbench import arith


def read(trace, cell):
    flops = trace.work.get("flops", 0)
    if not flops or trace.busy_s == 0:
        return None
    return 100.0 * flops / (trace.window_s * arith.PEAK_F32_FLOPS)
