"""What the program's own tracing recorded in the traced slice, for the
metric readers: `tally()` of sealdnerf_tpu_torch/utils/profiling.py, the
spans ("sdn." in the trace) and counters of the run's one profiler session.
A program without that tracing gives nothing to read, and raises nothing."""


def read():
    """The traced tally, or None where the program keeps none."""
    try:
        from sealdnerf_tpu_torch.utils import profiling
    except ImportError:
        return None
    tally = getattr(profiling, "tally", None)
    return tally() if tally is not None else None


def stream_s(span: str):
    """The stream seconds of the span `span` (its name without "sdn."), or
    None where the tally holds none."""
    t = read()
    if not t:
        return None
    rec = t["spans"].get(span)
    return None if rec is None else rec["stream_s"]


def counter(*names):
    """The sum of the counters `names`, or None where the tally holds none
    of them."""
    t = read()
    if not t:
        return None
    vals = [t["counters"][n] for n in names if n in t["counters"]]
    return sum(vals) if vals else None
