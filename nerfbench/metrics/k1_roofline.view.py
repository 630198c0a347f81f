"""K1's share of its roofline in frames: the least time of the work given
to the static field's forward (work.field_work at each call's samples),
over the device time of everything launched inside those calls, in %."""


def read(s):
    dev = s.device_s("nb.k1")
    return 100.0 * s.bound_s("k1") / dev if dev else None
