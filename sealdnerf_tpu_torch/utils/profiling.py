"""The port's tracing: spans and counters inside the program, and the
--profile trace (port of sealdnerf_tpu/utils/profiling.py).

Spans. `span(name)` is a context manager around one phase of the program.
It is off unless a torch.profiler session is recording (the profiler's
own flag, a Python bool): off, it returns one shared no-op context and does
nothing else, since an unguarded record_function costs microseconds even
with no session. On, it opens `record_function("sdn." + name)`, so that the
phase sits in the profiler's Chrome trace beside the card's kernels, on one
clock; it adds its count and host seconds to the traced tally; and where
CUDA is in use it records a pair of timing events on the stream current
as it opens, which the tally turns into stream seconds (the span's kernels and any gap
that the host left inside it) only when it is read, so a span adds no wait.

Counters. `count(name, n)` adds a Python int to the process's total, and
while a session records to the traced tally as well; it never reads a
device value. `host_sync(on)` counts one "host_syncs" where `on` (a tensor
or device) is a CUDA device: the call sites on the frame and step paths
where the host waits for the card, explicit (.cpu(), int() of a device
value) or implicit (a copy from pageable host memory, a boolean-mask
index, whose size the host reads). `fetch(t)` is t.cpu() counted so, with
its bytes in "fetch_bytes": the fetches other than a frame's images.
`fetch_frame(*tensors)` fetches a frame's images: each CUDA tensor copied
without blocking into its own block of page-locked host memory from
PyTorch's caching host allocator, then one wait for all of them (one
"host_syncs"), the bytes in "fetch_bytes" and "fetch_pinned_bytes".

`tally(traced=True)` -> {"counters": {name: int}, "spans": {name: {"n",
"host_s", "stream_s"}}}: the traced tally (stream_s None where the span
recorded no events), or with traced=False the process's counter totals
(spans are kept only while a session records). `reset_traced()` clears
the traced tally.

The spans (in the trace as "sdn.<name>"), their phases and the counters:
- frame: the whole of a trainer's render_image; inside it frame.setup (the
  params, the bin's occupancy, the tile pick), frame.march (the tile rays
  and their coarse march), frame.trim (the termination trim),
  frame.order (the tile counts, their order and fetch), frame.bucket (one
  per bucket rendered: samples, field and compositing), frame.stitch
  (the buckets back to the frame's pixels) and frame.fetch (image and
  depth to the host);
- composite: the dense compositing of frames and training steps;
- k1, k2, k3, k4, k5: one call of the field's forward, backward, dynamic
  forward and dynamic backward, and of the Instant-NGP hash-grid field's
  forward (ops/field.py);
- step: a FastTrainer training step, with step.sample, step.forward,
  step.backward and step.update inside it; grid.refresh and grid.rebuild.
- counters: k1.calls .. k5.calls (the calls that reached the kernel),
  k1.samples .. k5.samples (their samples), k5.density_samples (those of
  K5's density-only calls), host_syncs, fetch_bytes (what
  a frame copies from the card to the host), fetch_pinned_bytes (the part
  of it that fetch_frame copied into page-locked memory).

The --profile trace. `profile_trace(logdir)` is a context manager around
torch.profiler.profile: the host's operators and the program's spans
always, and the card's kernels and copies when the run is on a CUDA
device. On exit it writes a Chrome / Perfetto trace,
`rank{r}.pt.trace.json`, and the session's traced tally,
`rank{r}.counters.json`, into logdir: the reference's trace covers every
device of its mesh, so every rank of a data mesh writes its own, one pair
of files a rank. A failed export raises. Open the trace in
https://ui.perfetto.dev or chrome://tracing.

The CLIs wrap their train and test calls in it under --profile
(cli.profiled), writing to <workspace>/trace. A profiling session leaves a
cost on the launches that its process makes afterwards
(profiling/torch_profiler_residue.py), so nothing timed runs after it.

The reference's enable_nan_debugging is --debug_nan (cli.postprocess), and
its StepTimer, which nothing of the reference calls, is not ported.
"""

import contextlib
import json
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
# span records whose events are folded into seconds once this many pend
_FOLD_AT = 256

_totals = {}            # counter -> int, the process's
_counters = {}          # counter -> int, while a session records
_spans = {}             # span -> _SpanRecord, while a session records
_streams = {}           # (device, raw stream) -> torch.cuda.Stream


class _SpanRecord:
    __slots__ = ("n", "host_s", "stream_s", "events", "timed")

    def __init__(self):
        self.n, self.host_s, self.stream_s, self.events = 0, 0.0, 0.0, []
        self.timed = False

    def fold(self, wait: bool):
        """Turn the event pairs into seconds: every pair with wait, else
        those whose end the card has reached."""
        pending = []
        for start, end in self.events:
            if wait:
                end.synchronize()
            elif not end.query():
                pending.append((start, end))
                continue
            self.stream_s += start.elapsed_time(end) * 1e-3
        self.events = pending


def _current_stream():
    """The current CUDA stream, its object looked up by the raw handle
    (torch.cuda.current_stream() builds a new one, some 6 us a call)."""
    dev = torch.cuda.current_device()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(dev)
    return stream


class _Span:
    __slots__ = ("name", "rf", "t0", "ev", "stream")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function("sdn." + self.name)
        self.rf.__enter__()
        self.ev = None
        if torch.cuda.is_initialized():
            # both events on the stream that is current as the span opens
            self.stream = _current_stream()
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        rec = _spans.get(self.name)
        if rec is None:
            rec = _spans[self.name] = _SpanRecord()
        rec.n += 1
        rec.host_s += dt
        if self.ev is not None:
            self.ev[1].record(self.stream)
            rec.events.append(self.ev)
            rec.timed = True
            if len(rec.events) >= _FOLD_AT:
                rec.fold(wait=False)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """The phase `name`: "sdn.<name>" in the trace and in the traced tally
    while a profiler session records; a shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1):
    """Add n to the counter `name` (a Python int; never a device value)."""
    _totals[name] = _totals.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def host_sync(on, n: int = 1):
    """Count n waits of the host for the card at a call site whose tensor
    or device is `on`; nothing when that is not a CUDA device."""
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type == "cuda":
        count("host_syncs", n)


def fetch(t):
    """t.cpu(), counted where t is on a CUDA device: one "host_syncs" and
    its bytes in "fetch_bytes"."""
    if t.device.type == "cuda":
        count("host_syncs")
        count("fetch_bytes", t.numel() * t.element_size())
    return t.cpu()


def fetch_frame(*tensors):
    """The tensors as numpy arrays on the host, with one wait. A CUDA
    tensor is copied without blocking into a block of page-locked host
    memory that PyTorch's caching host allocator serves (from its cache
    once a frame of the same sizes has been fetched), its bytes counted in
    "fetch_bytes" and "fetch_pinned_bytes"; then one synchronize of the
    current stream waits for all of the copies (one "host_syncs"). Each
    array owns its block, which goes back to the cache when the array is
    dropped: a caller that keeps arrays keeps their memory pinned. A CPU
    tensor is returned as its .numpy()."""
    out, device = [], None
    for t in tensors:
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            n = t.numel() * t.element_size()
            count("fetch_bytes", n)
            count("fetch_pinned_bytes", n)
            t, device = host, t.device
        out.append(t.numpy())
    if device is not None:
        count("host_syncs")
        torch.cuda.current_stream(device).synchronize()
    return tuple(out)


def tally(traced: bool = True) -> dict:
    """The traced tally, {"counters": {...}, "spans": {name: {"n",
    "host_s", "stream_s"}}}, with every span's events turned into seconds
    (which waits for them); traced=False: the process's counter totals and
    no spans."""
    if not traced:
        return {"counters": dict(_totals), "spans": {}}
    spans = {}
    for name, rec in _spans.items():
        rec.fold(wait=True)
        spans[name] = {"n": rec.n, "host_s": rec.host_s,
                       "stream_s": rec.stream_s if rec.timed else None}
    return {"counters": dict(_counters), "spans": spans}


def reset_traced():
    """Clear the traced tally (the process's totals stay)."""
    _counters.clear()
    _spans.clear()


def trace_path(logdir: str, rank: int) -> str:
    """The trace file of rank `rank` in logdir."""
    return os.path.join(logdir, f"rank{rank}.pt.trace.json")


def counters_path(logdir: str, rank: int) -> str:
    """The traced tally of rank `rank`'s session in logdir."""
    return os.path.join(logdir, f"rank{rank}.counters.json")


@contextlib.contextmanager
def profile_trace(logdir: str, device=None, rank: int = 0):
    """Profile the body; on exit write rank `rank`'s trace and traced tally
    into logdir, then clear the tally. device: the run's torch device (a
    CUDA device adds the card's activity). Yields the
    torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    reset_traced()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(trace_path(logdir, rank))
        with open(counters_path(logdir, rank), "w") as f:
            json.dump(tally(), f, indent=1, sort_keys=True)
        reset_traced()
