"""The share of the profiled sub-window's wall time in which no operation
(kernel, copy or set) ran on the device, in %.  Layer: device."""


def read(tr):
    if not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
