"""Hash-grid field samples evaluated a frame, counted inside the program:
its counter k5.samples (every call of K5, the termination trim's taps
included) in the traced slice, over its frames."""

from nerfbench import program_tally


def read(s):
    n = program_tally.counter("k5.samples")
    return n / s.units if n else None
