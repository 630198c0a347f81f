"""Field samples evaluated a frame, counted inside the program: its
counters k1.samples and k3.samples (every call of the static or dynamic
field forward, the termination trim's taps included) in the traced slice,
over its frames."""

from nerfbench import program_tally


def read(s):
    n = program_tally.counter("k1.samples", "k3.samples")
    return n / s.units if n else None
