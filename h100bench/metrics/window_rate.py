"""Units completed in the window over the time from its start to the
last unit completed in it (an end-to-end rate: all the work and all the
time of the window)."""


def read(spec, window, trace):
    if window.units == 0 or window.elapsed_s <= 0:
        return None
    return window.units / window.elapsed_s
