"""The frames' share of the card's peak: the least time of the operations
of every field evaluation of the slice's frames, at the tensor-core and
FP32 peaks, over the slice's seconds, in %."""


def read(s):
    ops = s.op_s(("k1", "k3"))
    return 100.0 * ops / s.slice_s if ops else None
