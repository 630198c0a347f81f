"""The frames' share of the card's peak on the Instant-NGP field: the least
time of the operations of the traced slice's K5 calls (work_hash.py at the
program's counters k5.calls, k5.samples and k5.density_samples), at the
tensor-core and FP32 peaks, over the slice's seconds, in %."""

from nerfbench import program_tally, work_hash


def read(s):
    calls = program_tally.counter("k5.calls")
    if not calls:
        return None
    n = program_tally.counter("k5.samples") or 0
    nd = program_tally.counter("k5.density_samples") or 0
    return 100.0 * work_hash.op_seconds(s.cfg, calls, n, nd) / s.slice_s
