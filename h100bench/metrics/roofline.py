"""A kernel's share of its roofline over the traced stretch: the least
time the card needs for the work the stretch's units hold
(tally.bound_s of the tally named `tally`, counted from true sizes),
over the device time of the kernels whose names hold one of `kernels`.
Nothing to read when no such kernel ran."""

from h100bench import tally as tally_mod


def read(spec, window, trace):
    if trace is None:
        return None
    t = trace.kernel_time(include=spec["kernels"])
    launches = trace.tally.get(spec["tally"])
    if t <= 0 or not launches:
        return None
    return 100.0 * tally_mod.bound_s(launches, trace.peaks) / t
