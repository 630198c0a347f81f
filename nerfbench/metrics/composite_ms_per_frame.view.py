"""The card's time a frame in compositing: the stream seconds of the
program's span sdn.composite (the dense compositing of every bucket) in the
traced slice, over its frames, in ms."""

from nerfbench import program_tally


def read(s):
    v = program_tally.stream_s("composite")
    return 1e3 * v / s.units if v else None
