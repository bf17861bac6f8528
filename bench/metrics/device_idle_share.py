"""device_idle_share (layer: device): over the traced stretch of the
window, one minus the share of its wall time in which some operation ran
on the device (the union of the profiler's device intervals)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 1.0 - r.trace.busy_s / r.trace.window_s
