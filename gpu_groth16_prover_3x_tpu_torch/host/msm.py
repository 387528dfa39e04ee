"""Host-side exact multi-scalar multiplication and fixed-base exponentiation.

Oracle equivalents of the reference's CPU multiexp stack
(depends/libff/libff/algebra/scalar_multiplication/multiexp.tcc):
  - `msm`            ~ multi_exp_with_mixed_addition<BDLO12> (:165-283),
                       the Pippenger bucket method the CPU prover uses
                       (libsnark/main.cpp:24,150-170)
  - `window_table` / `batch_exp`
                     ~ get_window_table (:547-585) / batch_exp (:587-650),
                       used by the trusted-setup generator
                       (r1cs_gg_ppzksnark.tcc:289-345)

Results are group elements, so only mathematical equality matters; the
algorithms here are chosen for clarity + acceptable Python speed, and they
double as the executable spec for the device Pippenger MSM in ops/msm.py.
"""

import math
from typing import List, Sequence

from ..utils import native
from .ec import Group, Point


def _window_bits(n: int) -> int:
    """The libff window heuristic log2(n) - (log2(n)/3 - 2) (multiexp.tcc:177)."""
    logn = max(int(math.log2(n)), 1) if n > 1 else 1
    return min(16, max(2, logn - (logn // 3 - 2)))


def msm(group: Group, scalars: Sequence[int], points: Sequence[Point]) -> Point:
    """Pippenger bucket MSM: sum_i scalars[i] * points[i]."""
    assert len(scalars) == len(points)
    n = len(scalars)
    if n == 0:
        return group.zero
    scalars = [int(s) for s in scalars]
    maxbits = max((s.bit_length() for s in scalars), default=1)
    if maxbits == 0:
        return group.zero
    c = _window_bits(n)
    # native C++ Pippenger (csrc/limb_host.cpp g16_msm) when available --
    # required for reference-scale (2^16+) oracle runs
    if n >= 64 and maxbits <= 753 and min(scalars) >= 0:
        res = native.msm_jacobian(
            group.p, group.deg, group.alpha, group.a, points, scalars, c)
        if res is not None:
            return res
    num_windows = (maxbits + c - 1) // c
    mask = (1 << c) - 1

    result = group.zero
    for w in range(num_windows - 1, -1, -1):
        for _ in range(c):
            result = group.dbl(result)
        buckets: List[Point] = [group.zero] * ((1 << c) - 1)
        shift = w * c
        for s, pt in zip(scalars, points):
            digit = (s >> shift) & mask
            if digit:
                buckets[digit - 1] = group.add(buckets[digit - 1], pt)
        # suffix-sum accumulation: sum_b b * bucket_b
        running = group.zero
        window_sum = group.zero
        for b in range(len(buckets) - 1, -1, -1):
            running = group.add(running, buckets[b])
            window_sum = group.add(window_sum, running)
        result = group.add(result, window_sum)
    return result


def msm_naive(group: Group, scalars, points) -> Point:
    """Direct double-and-add sum, for cross-checking `msm` in tests."""
    acc = group.zero
    for s, pt in zip(scalars, points):
        acc = group.add(acc, group.mul(int(s), pt))
    return acc


# -- fixed-base windowed exponentiation (setup path) -------------------------

# wNAF window thresholds (scalar_bits -> window i+1), transcribed from
# the curve inits: G1 tables are {11,24,60,127} and G2 {5,15,39,109} for
# BOTH curves (mnt4753_init.cpp:144-148,205-209; mnt6753_init.cpp:158-161,
# 222-225).
WNAF_WINDOW_TABLE_G1 = [11, 24, 60, 127]
WNAF_WINDOW_TABLE_G2 = [5, 15, 39, 109]


def find_wnaf(window_size: int, scalar: int) -> List[int]:
    """Signed digits of `scalar` in width-w non-adjacent form
    (wnaf.tcc find_wnaf:21-59): digit 0 or odd u in (-2^w, 2^w)."""
    assert scalar >= 0
    res = []
    c = int(scalar)
    full = 1 << (window_size + 1)
    half = 1 << window_size
    while c:
        if c & 1:
            u = c % full
            if u > half:
                u -= full
            c -= u
        else:
            u = 0
        res.append(u)
        c >>= 1
    return res


def fixed_window_wnaf_exp(group: Group, window_size: int, base: Point,
                          scalar: int) -> Point:
    """scalar * base by wNAF with a 2^(w-1)-entry odd-multiples table
    (wnaf.tcc fixed_window_wnaf_exp:61-98)."""
    naf = find_wnaf(window_size, scalar)
    tmp, dbl = base, group.dbl(base)
    table = []
    for _ in range(1 << (window_size - 1)):
        table.append(tmp)            # 1, 3, 5, ... multiples
        tmp = group.add(tmp, dbl)
    res = group.zero
    found = False
    for u in reversed(naf):
        if found:
            res = group.dbl(res)
        if u:
            found = True
            t = table[abs(u) // 2]
            res = group.add(res, t if u > 0 else group.neg(t))
    return res


def opt_window_wnaf_exp(group: Group, base: Point, scalar: int,
                        scalar_bits: int, window_table: List[int] = None
                        ) -> Point:
    """Window size from the per-group threshold table
    (wnaf.tcc opt_window_wnaf_exp:100-122)."""
    table = window_table or WNAF_WINDOW_TABLE_G1
    best = 0
    for i in range(len(table) - 1, -1, -1):
        if scalar_bits >= table[i]:
            best = i + 1
            break
    if best > 0:
        return fixed_window_wnaf_exp(group, best, base, scalar)
    return group.mul(scalar, base)


def get_exp_window_size(num_scalars: int) -> int:
    """Simplified analog of libff::get_exp_window_size (multiexp.tcc:509-545)."""
    if num_scalars < 32:
        return 3
    return min(14, max(3, int(math.log2(num_scalars))))


def window_table(group: Group, scalar_bits: int, window: int,
                 base: Point) -> List[List[Point]]:
    """powers_of_g[w][j] = (j << (w*window)) * base  (multiexp.tcc:547-585)."""
    in_window = 1 << window
    outerc = (scalar_bits + window - 1) // window
    table: List[List[Point]] = []
    g_outer = base
    for _ in range(outerc):
        row = [group.zero] * in_window
        g_inner = group.zero
        for j in range(in_window):
            row[j] = g_inner
            g_inner = group.add(g_inner, g_outer)
        table.append(row)
        for _ in range(window):
            g_outer = group.dbl(g_outer)
    return table


def windowed_exp(group: Group, scalar_bits: int, window: int,
                 table: List[List[Point]], scalar: int) -> Point:
    outerc = (scalar_bits + window - 1) // window
    mask = (1 << window) - 1
    res = group.zero
    s = int(scalar)
    for w in range(outerc):
        res = group.add(res, table[w][(s >> (w * window)) & mask])
    return res


def fixed_base_msm(group: Group, base: Point, scalars: Sequence[int],
                   window: int = None) -> List[Point]:
    """[s * base for s in scalars] via one windowed table.

    The get_window_table + batch_exp pairing of the trusted setup
    (r1cs_gg_ppzksnark.tcc:289-345) as a single call, so the native
    C++ kernel (csrc/limb_host.cpp g16_fixed_base_batch) can build its
    table once and stream the scalars.  Falls back to the Python table
    path when the native library is unavailable.
    """
    scalars = [int(s) for s in scalars]
    if window is None:
        window = get_exp_window_size(len(scalars))
    if scalars and min(scalars) >= 0 and not group.is_zero(base):
        res = native.fixed_base_batch(
            group.p, group.deg, group.alpha, group.a, base, scalars, window)
        if res is not None:
            return res
    table = window_table(group, 753, window, base)
    return batch_exp(group, 753, window, table, scalars)


def batch_exp(group: Group, scalar_bits: int, window: int,
              table: List[List[Point]], scalars: Sequence[int],
              coeff: int = None, modulus: int = None) -> List[Point]:
    """table-based multi-exponentiation (multiexp.tcc:587-680).

    With `coeff` set, computes (coeff * s) * base like batch_exp_with_coeff
    (used for the H-query, r1cs_gg_ppzksnark.tcc:331).
    """
    out = []
    for s in scalars:
        k = int(s) if coeff is None else (coeff * int(s)) % modulus
        out.append(windowed_exp(group, scalar_bits, window, table, k))
    return out
