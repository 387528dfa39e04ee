"""Nested block timers (libff enter_block/leave_block equivalent).

Mirrors depends/libff/libff/common/profiling.cpp:241-327: a stack of named
regions printing wall time with indentation to stderr.  `last_laps` keeps
the most recent duration per label for harnesses.
"""

import sys
import time

_stack = []
_last_laps = {}


def last_laps() -> dict:
    """Most recent wall time per block label."""
    return dict(_last_laps)


def enter_block(name: str) -> None:
    print(f"{'  ' * len(_stack)}(enter) {name}", file=sys.stderr, flush=True)
    _stack.append((name, time.perf_counter()))


def leave_block(name: str) -> None:
    top, start = _stack.pop()
    if top != name:
        raise RuntimeError(f"unbalanced blocks: {top} vs {name}")
    dt = time.perf_counter() - start
    _last_laps[name] = dt
    print(f"{'  ' * len(_stack)}(leave) {name} [{dt:.4f}s]",
          file=sys.stderr, flush=True)


def log_device_memory(label: str = "") -> dict:
    """Peak and current CUDA allocator memory (the reference prints GPU
    memory mid-kernel, multiexp/reduce.cu:184-191).  Empty without a
    card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    st = {"peak_bytes": torch.cuda.max_memory_allocated(),
          "bytes_in_use": torch.cuda.memory_allocated()}
    print(f"{label + ': ' if label else ''}cuda memory "
          f"{st['bytes_in_use'] / 2**30:.2f} GiB in use, "
          f"peak {st['peak_bytes'] / 2**30:.2f} GiB",
          file=sys.stderr, flush=True)
    return st
