"""K4's share of its roofline: the least time of the dynamic backward's
work (work.field_work at each call's samples and samples with a
cotangent), over the device time of everything launched inside those
calls (all of its device kernels), in %."""


def read(s):
    dev = s.device_s("nb.k4")
    return 100.0 * s.bound_s("k4") / dev if dev else None
