"""Spans and counters that the benchmark opens around the program's layers
in a traced run, and the reduction of the profiler's trace to what the
per-layer metrics read.

`Probe` wraps, for the traced slice only, the field's entry points (K1
`field_forward`, K2 `field_backward`, K3 `dyn_field_forward`, K4
`dyn_field_backward`) and the trainer's grid refresh in
`torch.profiler.record_function` spans named "nb.<layer>", and counts each
field call's samples (and, for a backward, the samples with a cotangent).
The benchmark's loop opens "nb.slice" around the traced slice and
"nb.step" / "nb.frame" around each step or frame.

`read_trace` matches every device operation of the slice to the runtime
call that launched it (the trace's correlation ids) and so to the "nb."
spans open on the launching thread at the time: the device time under a
span is what was launched inside it, whatever the kernels are named.
"""

import collections
import inspect
import json

import torch

from . import work

# the layers whose calls the probe counts: module attribute -> layer
FIELD_CALLS = {"field_forward": "k1", "field_backward": "k2",
               "dyn_field_forward": "k3", "dyn_field_backward": "k4"}
# the work each layer's call is given (work.field_work's mode)
MODES = {"k1": "fwd", "k2": "bwd", "k3": "dyn", "k4": "dyn_bwd"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Probe:
    """The traced run's spans and counters around the program's calls."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.calls = []          # (layer, m, density_only, live, lod_skip)
        self.recording = False
        self._saved = []

    def _wrap(self, layer, fn):
        sig = inspect.signature(fn)
        probe = self

        def wrapped(*args, **kwargs):
            if not probe.recording:
                return fn(*args, **kwargs)
            a = sig.bind(*args, **kwargs).arguments
            live = None
            if "g_out" in a:
                # outside the span: a reduction of the benchmark's own
                live = (a["g_out"] != 0).any(0).sum()
            probe.calls.append((layer, int(a["x3"].shape[1]),
                                bool(a.get("density_only", False)), live,
                                tuple(a.get("lod_skip", ()))))
            with torch.profiler.record_function("nb." + layer):
                return fn(*args, **kwargs)
        # the program counts its launches on the function object
        wrapped.launches = getattr(fn, "launches", 0)
        return wrapped

    def install(self):
        from sealdnerf_tpu_torch.ops import field
        from sealdnerf_tpu_torch.train import fast
        for attr, layer in FIELD_CALLS.items():
            orig = getattr(field, attr)
            w = self._wrap(layer, orig)
            for mod in (field, fast):
                if getattr(mod, attr, None) is orig:
                    self._saved.append((mod, attr, orig, w))
                    setattr(mod, attr, w)
        refresh = self.trainer.refresh_grid

        def spanned_refresh(*args, **kwargs):
            with torch.profiler.record_function("nb.refresh"):
                return refresh(*args, **kwargs)
        self.trainer.refresh_grid = spanned_refresh
        return self

    def remove(self):
        for mod, attr, orig, w in self._saved:
            orig.launches = w.launches
            setattr(mod, attr, orig)
        self._saved = []
        self.trainer.__dict__.pop("refresh_grid", None)

    def field_calls(self):
        """The slice's calls with their live counts read back."""
        return [(layer, m, do, m if live is None else int(live), skip)
                for layer, m, do, live, skip in self.calls]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Slice:
    """What the metric readers read from a traced slice: its seconds, the
    device's busy seconds, the steps or frames in it, the device kernels
    launched, the device seconds launched under each "nb." span, the field
    calls of the probe and the field configuration."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def device_s(self, span: str) -> float:
        return self.span_device_s.get(span, 0.0)

    def calls_of(self, layer: str):
        return [c for c in self.calls if c[0] == layer]

    def op_s(self, layers) -> float:
        """The least seconds of the calls' operations at the peaks."""
        return sum(work.op_seconds(self.cfg, m, mode=MODES[layer],
                                   density_only=do, m_live=live,
                                   lod_skip=skip)
                   for layer, m, do, live, skip in self.calls
                   if layer in layers)

    def bound_s(self, layer: str) -> float:
        """The least seconds of the layer's calls (their rooflines)."""
        return sum(work.bound_seconds(self.cfg, m, mode=MODES[layer],
                                      density_only=do, m_live=live,
                                      lod_skip=skip)
                   for _, m, do, live, skip in self.calls_of(layer))


def read_trace(path: str, cfg: dict, units: int, calls) -> Slice:
    """Reduce a Chrome trace written by torch.profiler to a Slice."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("nb.")]
    sl = [e for e in spans if e["name"] == "nb.slice"]
    if len(sl) != 1:
        raise RuntimeError(f"the trace holds {len(sl)} nb.slice spans")
    t0, t1 = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"]
    main_tid = sl[0]["tid"]
    by_tid = collections.defaultdict(list)
    for e in spans:
        by_tid[e["tid"]].append(e)
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    span_dev = collections.defaultdict(float)
    by_name = collections.defaultdict(float)
    busy, n_kernels = [], 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        busy.append((a, b))
        dur = (b - a) * 1e-6
        by_name[e["name"]] += dur
        n_kernels += e["cat"] == "kernel"
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is None:
            continue
        names = {s["name"] for s in by_tid.get(src["tid"], ())
                 if s["ts"] <= src["ts"] <= s["ts"] + s["dur"]}
        for n in names:
            span_dev[n] += dur
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    # the device's idle gaps, each labelled by the innermost benchmark span
    # and the innermost operator that the main thread was in as it began
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("tid") == main_tid
                  and e.get("cat") in ("cpu_op", "user_annotation")
                  and e["ts"] < t1 and e["ts"] + e["dur"] > t0),
                 key=lambda e: (e["ts"], -e["dur"]))
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = collections.defaultdict(float)
    stack, i = [], 0     # the main thread's open events, outermost first
    for g0, g1 in zip(edges[::2], edges[1::2]):
        while i < len(ops) and ops[i]["ts"] <= g0:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ops[i]["ts"]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= g0:
            stack.pop()
        if g1 <= g0:
            continue
        nb = [e["name"] for e in stack if e["name"].startswith("nb.")
              and e["name"] != "nb.slice"]
        op = [e["name"] for e in stack if not e["name"].startswith("nb.")]
        label = (nb[-1] if nb else "nb.slice") + (" > " + op[-1] if op else "")
        gaps[label] += (g1 - g0) * 1e-6
    return Slice(slice_s=(t1 - t0) * 1e-6, busy_s=busy_s, units=units,
                 n_kernels=n_kernels, span_device_s=dict(span_dev),
                 calls=calls, cfg=cfg,
                 device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                 idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10])
