"""K3's share of its roofline in training (the steps' forward and the
refresh's density queries): the least time of the work given to it, over
the device time of everything launched inside those calls, in %."""


def read(s):
    dev = s.device_s("nb.k3")
    return 100.0 * s.bound_s("k3") / dev if dev else None
