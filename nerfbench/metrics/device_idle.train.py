"""The share of the traced training slice in which no operation ran on
the device, in %."""


def read(s):
    return 100.0 * (1.0 - s.busy_s / s.slice_s) if s.busy_s else None
