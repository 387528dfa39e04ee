"""Arithmetic op counters (the reference's PROFILE_OP_COUNTS).

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/utils/opcount.py.
The reference tallies field multiplies and group operations behind
`#ifdef PROFILE_OP_COUNTS` (libff fp.hpp:46-51, profiling.cpp:119-150).
PyTorch runs eagerly, so the counts are taken at call time: each kernel
wrapper records the lanes it computes, on the CUDA route and on the plain
route alike, so a tally on the CPU equals the tally of the same run on
the card.  The kinds:

  fp_mont_mul     lanes of the Montgomery product (ops/mont_mul.mont_mul)
  ec_add, ec_dbl, ec_mixed_add
                  lanes of the group kernels (ops/group_kernels.py)
  msm_scan_step   point-steps of the bucket scan (ops/msm.msm_scan: S
                  steps x B chunks a launch)

Counting is off unless a `collect()` scope is open; then a hook is one
dictionary update.  `scale(k)` multiplies what is recorded inside it, for
a caller that runs one call for k steps of work.

    from ..utils import opcount
    with opcount.collect() as tally:
        prove(...)
    print(opcount.report(tally))
"""

from contextlib import contextmanager
from typing import Dict, Optional

_active: Optional[Dict[str, int]] = None
_scale = 1


def enabled() -> bool:
    return _active is not None


def add(kind: str, n: int = 1) -> None:
    """Record n units of `kind` at the current scale."""
    if _active is not None:
        _active[kind] = _active.get(kind, 0) + n * _scale


@contextmanager
def scale(factor: int):
    """Multiply the counts recorded inside by `factor`."""
    global _scale
    prev = _scale
    _scale = prev * int(factor)
    try:
        yield
    finally:
        _scale = prev


@contextmanager
def collect():
    """Collect the counts of every op run inside the scope."""
    global _active, _scale
    prev, prev_scale = _active, _scale
    tally: Dict[str, int] = {}
    _active, _scale = tally, 1
    try:
        yield tally
    finally:
        _active, _scale = prev, prev_scale


def report(tally: Dict[str, int]) -> str:
    """profiling.cpp:119-150-style one line per counter."""
    lines = ["op counts (lanes of work run):"]
    for k in sorted(tally):
        lines.append(f"  {k:<24} {tally[k]:>16,}")
    return "\n".join(lines)
