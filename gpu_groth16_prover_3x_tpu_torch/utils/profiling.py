"""Nested block timers (libff enter_block/leave_block equivalent).

Mirrors depends/libff/libff/common/profiling.cpp:241-327: a stack of named
regions printing wall time with indentation to stderr, plus the GPU
prover's flat `print_time` phase labels (cuda_prover_piecewise.cu:87-94,
PhaseTimer).  `last_laps` keeps the most recent duration per label for
harnesses whether or not printing is on; set_profiling_enabled switches
the printing (on by default).  The counterpart of the JAX package's
utils/profiling.py.
"""

import sys
import time
from contextlib import contextmanager

_enabled = True
_stack = []
_last_laps = {}    # most recent duration per block name (see last_laps)


def last_laps() -> dict:
    """Most recent wall time per block label."""
    return dict(_last_laps)


def clear_laps() -> None:
    _last_laps.clear()


def set_profiling_enabled(flag: bool) -> None:
    global _enabled
    _enabled = flag


def _indent() -> str:
    return "  " * len(_stack)


def enter_block(name: str) -> None:
    if _enabled:
        print(f"{_indent()}(enter) {name}", file=sys.stderr, flush=True)
    _stack.append((name, time.perf_counter()))


def leave_block(name: str) -> None:
    top, start = _stack.pop()
    if top != name:
        raise RuntimeError(f"unbalanced blocks: {top} vs {name}")
    dt = time.perf_counter() - start
    _last_laps[name] = dt
    if _enabled:
        print(f"{_indent()}(leave) {name} [{dt:.4f}s]", file=sys.stderr,
              flush=True)


@contextmanager
def block(name: str):
    enter_block(name)
    try:
        yield
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


class PhaseTimer:
    """print_time-style running phase timer (cuda_prover_piecewise.cu:87-94):
    `lap` records the time since the previous lap, `total` the time since
    the timer was made, both in `laps`."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.laps = {}

    def lap(self, label: str) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.laps[label] = dt
        if _enabled:
            print(f"{label}: {dt * 1e6:.0f} us", file=sys.stderr, flush=True)
        self.last = now
        return dt

    def total(self, label: str = "total") -> float:
        dt = time.perf_counter() - self.t0
        self.laps[label] = dt
        if _enabled:
            print(f"{label}: {dt * 1e6:.0f} us", file=sys.stderr, flush=True)
        return dt
