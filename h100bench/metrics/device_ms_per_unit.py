"""Device milliseconds per unit of the traced stretch, of the kernels
whose names hold one of `include` (all when empty) and none of
`exclude`."""


def read(spec, window, trace):
    if trace is None or trace.units == 0:
        return None
    t = trace.kernel_time(include=spec.get("include", ()),
                          exclude=spec.get("exclude", ()))
    if t <= 0:
        return None
    return 1e3 * t / trace.units
