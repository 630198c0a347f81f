"""Field samples evaluated a frame: the samples of every field call (K1 or
K3, the termination trim's taps included) of the traced slice over its
frames."""


def read(s):
    n = sum(m for layer, m, *_ in s.calls if layer in ("k1", "k3"))
    return n / s.units if n else None
