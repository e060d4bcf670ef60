"""prop_launches.<cell kind>: propagation kernel launches per request, from
the program's own counter (ops/labelprop_cuda.launches) over the traced
slice."""


def read(trace, cell):
    n = trace.counters.get("prop_launches")
    if not n or trace.requests == 0:
        return None
    return n / trace.requests
