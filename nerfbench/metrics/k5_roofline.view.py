"""K5's share of its roofline in frames: the least time of the work given
to the hash-grid field's forward (work_hash.py at the traced slice's
counted calls, samples and density-only samples: the program's counters
k5.calls, k5.samples, k5.density_samples), over the stream seconds of the
program's span sdn.k5, in %."""

from nerfbench import program_tally, work_hash


def read(s):
    dev = program_tally.stream_s("k5")
    calls = program_tally.counter("k5.calls")
    if not dev or not calls:
        return None
    n = program_tally.counter("k5.samples") or 0
    nd = program_tally.counter("k5.density_samples") or 0
    return 100.0 * work_hash.bound_seconds(s.cfg, calls, n, nd) / dev
