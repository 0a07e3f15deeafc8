"""The share of the traced stretch's host-clock length in which no
operation ran on the device, in percent."""


def read(spec, window, trace):
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.window_s)
