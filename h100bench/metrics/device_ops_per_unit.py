"""Device operations (kernels, copies, fills: the profiler's device
events) per unit of the traced stretch."""


def read(spec, window, trace):
    if trace is None or trace.units == 0:
        return None
    n = trace.kernel_count(include=spec.get("include", ()),
                           exclude=spec.get("exclude", ()))
    return n / trace.units if n else None
