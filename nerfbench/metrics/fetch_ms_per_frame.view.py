"""The card's time a frame in the fetch of its image and depth to the
host: the stream seconds of the program's span sdn.frame.fetch in the
traced slice, over its frames, in ms."""

from nerfbench import program_tally


def read(s):
    v = program_tally.stream_s("frame.fetch")
    return 1e3 * v / s.units if v else None
