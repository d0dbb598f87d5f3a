"""The device's idle share of the traced window, in percent: one minus the
time in which some operation ran on the device (the profiler's trace) over
the window's length."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
