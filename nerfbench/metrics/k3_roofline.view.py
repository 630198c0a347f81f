"""K3's share of its roofline in frames: the least time of the work given
to the dynamic field's forward (work.field_work at each call's samples),
over the device time of everything launched inside those calls, in %."""


def read(s):
    dev = s.device_s("nb.k3")
    return 100.0 * s.bound_s("k3") / dev if dev else None
