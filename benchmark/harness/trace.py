"""What a traced run records, and how the device trace is read.

Three recorders, each switched on only for the window of a `--trace 1`
run and each undone when it closes:

- `Launches`: the port calls its CUDA kernels through ctypes entry points
  that it looks up on `ops.build.library()` at every launch; the recorder
  hands out a proxy of that library which notes each entry point's name
  and integer arguments (lane counts, S and B of a scan) before the call.
- `Spans`: a host clock around the port's file loaders (load_params,
  load_input, load_preprocessed of models/gpu_prover.py), per proof.
- `Annotations`: each of the port's block timers (enter_block /
  leave_block of models/gpu_prover.py) opens and closes a
  torch.profiler.record_function range of the same name, so the idle
  gaps of the device can be labelled with the block the host was in.

`read_profile` turns the profiler's events into busy and idle time, the
device time per kernel name and the breakdown.
"""

import re
import time
from contextlib import ExitStack

import torch

PREFIX = "bench|"
WINDOW = PREFIX + "window"
OUTSIDE = "outside the prover's blocks"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class _Patch:
    """Replace a module attribute while open."""

    def __init__(self, mod, attr, value):
        self.mod, self.attr, self.value = mod, attr, value

    def __enter__(self):
        self.saved = getattr(self.mod, self.attr)
        setattr(self.mod, self.attr, self.value)

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.saved)


class _LibraryProxy:
    def __init__(self, lib, sink):
        self._lib, self._sink = lib, sink

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("g16_") or name == "g16_error_string":
            return fn
        sink = self._sink

        def launch(*args):
            sink.append((name, tuple(a if isinstance(a, int) else None
                                     for a in args)))
            return fn(*args)
        return launch


class Launches:
    """Every kernel launch of the port in the window: (entry point,
    integer arguments)."""

    def __init__(self):
        self.calls = []

    def patches(self):
        from gpu_groth16_prover_3x_tpu_torch.ops import build
        real = build.library
        sink = self.calls
        return [_Patch(build, "library",
                       lambda: _LibraryProxy(real(), sink))]


class Spans:
    """Host seconds in the port's file loaders, per proof (`take`)."""

    LOADERS = {"load_params": "load params", "load_input": "load inputs",
               "load_preprocessed": "load preprocessing"}

    def __init__(self):
        self.current = {}

    def take(self) -> dict:
        out, self.current = self.current, {}
        return out

    def patches(self):
        from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover
        out = []
        for attr, label in self.LOADERS.items():
            fn = getattr(gpu_prover, attr)

            def timed(*a, _fn=fn, _label=label, **k):
                with torch.profiler.record_function(PREFIX + _label):
                    t0 = time.perf_counter()
                    try:
                        return _fn(*a, **k)
                    finally:
                        self.current[_label] = self.current.get(
                            _label, 0.0) + time.perf_counter() - t0
            out.append(_Patch(gpu_prover, attr, timed))
        return out


class Annotations:
    """The port's block timers as profiler ranges."""

    def __init__(self):
        self.stack = []

    def patches(self):
        from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover
        enter, leave = gpu_prover.enter_block, gpu_prover.leave_block

        def enter_block(name):
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self.stack.append(rf)
            enter(name)

        def leave_block(name):
            leave(name)
            self.stack.pop().__exit__(None, None, None)
        return [_Patch(gpu_prover, "enter_block", enter_block),
                _Patch(gpu_prover, "leave_block", leave_block)]


def open_patches(stack: ExitStack, *recorders) -> None:
    for rec in recorders:
        for patch in rec.patches():
            stack.enter_context(patch)


def _kind(ev) -> str:
    """kernel, gpu_memcpy, gpu_memset, cuda_sync, gpu_user_annotation,
    user_annotation or cpu_op, by the event's device and name: the
    profiler's events carry no activity type in every torch version."""
    name = ev.name()
    if str(ev.device_type()).endswith("CUDA"):
        if name.startswith(PREFIX):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        if "Sync" in name:
            return "cuda_sync"
        return "kernel"
    return "user_annotation" if name.startswith(PREFIX) else "cpu_op"


def short_name(name: str) -> str:
    """A kernel's name without return type, arguments and template
    arguments: `void (anonymous namespace)::k_ec_add(unsigned int
    const*, ...)` -> `k_ec_add`."""
    s = name.replace("(anonymous namespace)::", "")
    s = s.split("(")[0]
    s = s.split("<")[0].strip()
    if s.startswith("void "):
        s = s[5:]
    return s[:120] or name[:120]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(notes, w0, w1):
    """The window cut into segments, each labelled with the innermost
    annotation open over it (OUTSIDE where none is)."""
    marks = sorted([(s, 1, i) for i, (s, e, _) in enumerate(notes)]
                   + [(e, 0, i) for i, (s, e, _) in enumerate(notes)])
    segs, open_, t = [], [], w0
    for when, starts, i in marks:
        when = min(max(when, w0), w1)
        if when > t:
            segs.append((t, when, notes[open_[-1]][2] if open_ else OUTSIDE))
            t = when
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
    if w1 > t:
        segs.append((t, w1, OUTSIDE))
    return segs


def _overlaps(gaps, segs):
    """(start, end, label) of each overlap of the sorted gaps with the
    sorted labelled segments."""
    k = 0
    for s, e in gaps:
        while k < len(segs) and segs[k][1] <= s:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < e:
            lo, hi = max(s, segs[j][0]), min(e, segs[j][1])
            if hi > lo:
                yield lo, hi, segs[j][2]
            j += 1


def read_profile(prof) -> dict:
    """Busy and idle seconds of the device inside the window, device
    seconds per kernel name, and the breakdown's two lists."""
    events = prof.profiler.kineto_results.events()
    device, notes, window = [], [], None
    for ev in events:
        kind = _kind(ev)
        if kind in DEVICE_KINDS:
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                           ev.name()))
        elif kind == "user_annotation" and ev.name().startswith(PREFIX):
            span = (ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                    ev.name()[len(PREFIX):])
            if ev.name() == WINDOW:
                window = span
            else:
                notes.append(span)
    if window is None:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = window[0], window[1]
    per_name, per_short = {}, {}
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        per_name[name] = per_name.get(name, 0) + (e - s)
        short = short_name(name)
        per_short[short] = per_short.get(short, 0) + (e - s)
    busy = _union(clipped)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = {}
    for s, e, label in _overlaps(gaps, _innermost(notes, w0, w1)):
        idle[label] = idle.get(label, 0) + (e - s)
    top = sorted(per_short.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in per_name.items()},
        "breakdown": {"device_ops": [[k, v / 1e9] for k, v in top],
                      "idle_gaps": [[k, v / 1e9] for k, v in gap_top]},
    }


def device_seconds(kernel_s: dict, device_name: str) -> float:
    """Device seconds of the kernels whose name holds `device_name` as a
    whole word."""
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(device_name)
                     + r"(?![A-Za-z0-9_])")
    return sum(v for k, v in kernel_s.items() if pat.search(k))
