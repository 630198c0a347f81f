"""The training step's share of the card's peak: the least time of the
operations of every field evaluation of the slice (the steps' forward,
the backward's samples with a cotangent, the grid refresh's queries), at
the tensor-core and FP32 peaks, over the slice's seconds, in %."""


def read(s):
    ops = s.op_s(("k1", "k2", "k3", "k4"))
    return 100.0 * ops / s.slice_s if ops else None
