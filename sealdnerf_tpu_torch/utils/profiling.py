"""The --profile trace (port of sealdnerf_tpu/utils/profiling.py).

`profile_trace(logdir)` is a context manager around torch.profiler.profile:
the host's operators always, and the card's kernels and copies when the run
is on a CUDA device. On exit it writes a Chrome / Perfetto trace,
`rank{r}.pt.trace.json`, into logdir: the reference's trace covers every
device of its mesh, so every rank of a data mesh writes its own, one file a
rank. A failed export raises. Open the file in https://ui.perfetto.dev or
chrome://tracing.

The CLIs wrap their train and test calls in it under --profile
(cli.profiled), writing to <workspace>/trace. A profiling session leaves a
cost on the launches that its process makes afterwards
(profiling/torch_profiler_residue.py), so nothing timed runs after it.

The reference's enable_nan_debugging is --debug_nan (cli.postprocess), and
its StepTimer, which nothing of the reference calls, is not ported.
"""

import contextlib
import os


def trace_path(logdir: str, rank: int) -> str:
    """The trace file of rank `rank` in logdir."""
    return os.path.join(logdir, f"rank{rank}.pt.trace.json")


@contextlib.contextmanager
def profile_trace(logdir: str, device=None, rank: int = 0):
    """Profile the body; on exit write rank `rank`'s trace into logdir.
    device: the run's torch device (a CUDA device adds the card's
    activity). Yields the torch.profiler.profile object."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(trace_path(logdir, rank))
