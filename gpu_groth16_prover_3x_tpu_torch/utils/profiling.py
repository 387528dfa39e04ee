"""Nested block timers (libff enter_block/leave_block equivalent) and the
per-proof record of spans and counters.

Mirrors depends/libff/libff/common/profiling.cpp:241-327: a stack of named
regions printing wall time with indentation to stderr.  The counterpart
of the JAX package's utils/profiling.py.

Every region is a span on one stack: `enter_block` / `leave_block` /
`block` print their lines while printing is on (set_profiling_enabled;
on by default), `span` never prints.  Closing a span adds to the record
that `last_laps` returns, whether or not printing is on:

  `<name>`        its host seconds, summed over every time it opened;
  `self:<name>`   the same less the seconds its child spans cover;
  `#<name>`       a counter's total (`count`).

`last_spans` gives the record's timeline: (name, parent, start_ns, end_ns)
of each closed span, on the epoch clock of time.time_ns(), which is the
clock of torch.profiler's events, so a span can be laid on a device
trace.  No span opens a profiler or NVTX range: a program range would
show in a device trace as device work.

A root span (`span(name, root=True)` opened with no span open) is one
request: the record holds what ran since the last root closed (or since
clear_laps) up to the end of the next root, so a caller that never calls
clear_laps reads the last request's record and keeps no more.  The
timeline is also capped at MAX_SPANS entries; spans past the cap are
counted under `#profiling.spans_dropped`.

An exception raised inside a span or `block` closes it and drops the
blocks that the exception left open inside it (an `enter_block` whose
`leave_block` never ran), so the exception comes through as raised and
the stack stays whole.
"""

import subprocess
import sys
import time
from contextlib import contextmanager

SELF = "self:"
COUNT = "#"
MAX_SPANS = 1 << 16

_enabled = True
_stack = []        # open spans: [name, is_root, start_ns, t0, child seconds]
_last_laps = {}    # the record (see the module docstring)
_spans = []        # its timeline
_done = False      # a root span has closed: the next span starts anew


def last_laps() -> dict:
    """The record: seconds, self seconds and counters by label."""
    return dict(_last_laps)


def last_spans() -> list:
    """The record's closed spans, (name, parent or None, start_ns,
    end_ns) in the order they closed."""
    return list(_spans)


def clear_laps() -> None:
    global _done
    _last_laps.clear()
    _spans.clear()
    _done = False


def set_profiling_enabled(flag: bool) -> None:
    global _enabled
    _enabled = flag


def _indent() -> str:
    return "  " * len(_stack)


def _start_record() -> None:
    if _done:
        clear_laps()


def _open(name: str, root: bool) -> None:
    _start_record()
    _stack.append([name, root and not _stack, time.time_ns(),
                   time.perf_counter(), 0.0])


def _close(name: str) -> float:
    global _done
    top, is_root, start_ns, t0, child = _stack.pop()
    if top != name:
        raise RuntimeError(f"unbalanced blocks: {top} vs {name}")
    dt = time.perf_counter() - t0
    end_ns = time.time_ns()
    _last_laps[name] = _last_laps.get(name, 0.0) + dt
    key = SELF + name
    _last_laps[key] = _last_laps.get(key, 0.0) + dt - child
    parent = None
    if _stack:
        _stack[-1][4] += dt
        parent = _stack[-1][0]
    if len(_spans) < MAX_SPANS:
        _spans.append((name, parent, start_ns, end_ns))
    else:
        count("profiling.spans_dropped")
    if is_root:
        _done = True
    return dt


def _unwind(depth: int) -> None:
    """Drop the spans an exception left open above `depth` (their
    seconds stay in the enclosing span's self time), so that the
    enclosing span closes and the exception comes through as raised."""
    del _stack[depth + 1:]


def count(name: str, n: int = 1) -> None:
    """Add n to the record's counter `#<name>`."""
    _start_record()
    key = COUNT + name
    _last_laps[key] = _last_laps.get(key, 0) + n


class span:
    """A silent span: `with span("ntt.addsub"): ...`; `.seconds` holds
    its duration once closed."""

    __slots__ = ("name", "root", "seconds", "_depth")

    def __init__(self, name: str, root: bool = False):
        self.name, self.root, self.seconds = name, root, None

    def __enter__(self):
        self._depth = len(_stack)
        _open(self.name, self.root)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.seconds = _close(self.name)
        elif len(_stack) > self._depth:
            _unwind(self._depth)
            self.seconds = _close(self.name)


def enter_block(name: str) -> None:
    if _enabled:
        print(f"{_indent()}(enter) {name}", file=sys.stderr, flush=True)
    _open(name, False)


def leave_block(name: str) -> None:
    dt = _close(name)
    if _enabled:
        print(f"{_indent()}(leave) {name} [{dt:.4f}s]", file=sys.stderr,
              flush=True)


@contextmanager
def block(name: str):
    depth = len(_stack)
    enter_block(name)
    try:
        yield
    except BaseException:
        _unwind(depth)
        raise
    finally:
        leave_block(name)


def log_device_memory(label: str = "") -> dict:
    """Peak and current CUDA allocator memory (the reference prints GPU
    memory mid-kernel, multiexp/reduce.cu:184-191), printed while
    profiling is enabled.  Empty without a card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    st = {"peak_bytes": torch.cuda.max_memory_allocated(),
          "bytes_in_use": torch.cuda.memory_allocated()}
    if _enabled:
        print(f"{label + ': ' if label else ''}cuda memory "
              f"{st['bytes_in_use'] / 2**30:.2f} GiB in use, "
              f"peak {st['peak_bytes'] / 2**30:.2f} GiB",
              file=sys.stderr, flush=True)
    return st


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them: a
    card may be set below its maximum power and then runs slower."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
