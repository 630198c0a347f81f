"""The waits of the host for the card a frame: the program's counter
host_syncs (each explicit or implicit wait, counted where it is made) in
the traced slice, over its frames."""

from nerfbench import program_tally


def read(s):
    n = program_tally.counter("host_syncs")
    return n / s.units if n else None
