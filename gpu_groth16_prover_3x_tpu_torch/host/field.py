"""Exact host-side field arithmetic (the framework's CPU oracle layer).

This replaces the role of the reference's vendored libff field stack
(depends/libff/libff/algebra/fields/fp.tcc, fp2.tcc, fp3.tcc) as the
trusted, exact implementation that golden vectors and end-to-end oracle
proofs are generated from.  It uses Python arbitrary-precision ints in the
*standard* (non-Montgomery) domain; Montgomery form only appears at the
serialization boundary (utils/serialization.py), matching how the reference
confines Montgomery limbs to its file format (libsnark/serialization.hpp).

Extension fields Fq2 = Fq[u]/(u^2 - alpha) and Fq3 = Fq[v]/(v^3 - alpha)
are tuples of ints with the non-residue alpha from curves/constants.py
(reference: mnt4753_init.cpp:105, mnt6753_init.cpp:109).
"""

from typing import Sequence, Tuple

Fp = int
Fpe = Tuple[int, ...]


# -- Prime field ------------------------------------------------------------

def inv(a: int, p: int) -> int:
    if a % p == 0:
        raise ZeroDivisionError("field inverse of zero")
    return pow(a, -1, p)


def batch_inv(xs: Sequence[int], p: int) -> list:
    """Montgomery's batch-inversion trick: one modular inverse for n values.

    Mirrors the role of libff batch_to_special_all_non_zeros
    (mnt4753_g1.cpp:485-503).  Zero entries are passed through as zero.
    """
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * (x if x % p else 1) % p
    total_inv = inv(prefix[n], p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        if xs[i] % p:
            out[i] = prefix[i] * total_inv % p
            total_inv = total_inv * xs[i] % p
    return out


# -- Extension field (deg 2 or 3, v^deg = alpha) -----------------------------

def e_zero(deg: int) -> Fpe:
    return (0,) * deg


def e_one(deg: int) -> Fpe:
    return (1,) + (0,) * (deg - 1)


def e_add(a: Fpe, b: Fpe, p: int) -> Fpe:
    return tuple((x + y) % p for x, y in zip(a, b))


def e_sub(a: Fpe, b: Fpe, p: int) -> Fpe:
    return tuple((x - y) % p for x, y in zip(a, b))


def e_neg(a: Fpe, p: int) -> Fpe:
    return tuple((-x) % p for x in a)


def e_scalar_mul(a: Fpe, k: int, p: int) -> Fpe:
    return tuple(x * k % p for x in a)


def e_mul(a: Fpe, b: Fpe, p: int, alpha: int) -> Fpe:
    deg = len(a)
    if deg == 1:
        return (a[0] * b[0] % p,)
    if deg == 2:
        a0, a1 = a
        b0, b1 = b
        t0 = a0 * b0
        t1 = a1 * b1
        # (a0 b1 + a1 b0) via Karatsuba
        t2 = (a0 + a1) * (b0 + b1) - t0 - t1
        return ((t0 + alpha * t1) % p, t2 % p)
    if deg == 3:
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        s01 = (a0 + a1) * (b0 + b1) - t0 - t1   # a0b1 + a1b0
        s02 = (a0 + a2) * (b0 + b2) - t0 - t2   # a0b2 + a2b0
        s12 = (a1 + a2) * (b1 + b2) - t1 - t2   # a1b2 + a2b1
        return (
            (t0 + alpha * s12) % p,
            (s01 + alpha * t2) % p,
            (s02 + t1) % p,
        )
    raise ValueError(f"unsupported extension degree {deg}")


def e_sqr(a: Fpe, p: int, alpha: int) -> Fpe:
    return e_mul(a, a, p, alpha)


def e_inv(a: Fpe, p: int, alpha: int) -> Fpe:
    deg = len(a)
    if deg == 1:
        return (inv(a[0], p),)
    if deg == 2:
        a0, a1 = a
        # norm = a0^2 - alpha a1^2
        norm = (a0 * a0 - alpha * a1 * a1) % p
        ninv = inv(norm, p)
        return (a0 * ninv % p, (-a1) * ninv % p)
    if deg == 3:
        a0, a1, a2 = a
        # libff fp3.tcc inverse (Grewal et al. / standard cubic formula)
        t0 = a0 * a0 % p
        t1 = a1 * a1 % p
        t2 = a2 * a2 % p
        t3 = a0 * a1 % p
        t4 = a0 * a2 % p
        t5 = a1 * a2 % p
        c0 = (t0 - alpha * t5) % p
        c1 = (alpha * t2 - t3) % p
        c2 = (t1 - t4) % p
        t6 = inv((a0 * c0 + alpha * (a2 * c1 + a1 * c2)) % p, p)
        return (t6 * c0 % p, t6 * c1 % p, t6 * c2 % p)
    raise ValueError(f"unsupported extension degree {deg}")


def e_equal(a: Fpe, b: Fpe, p: int) -> bool:
    return all((x - y) % p == 0 for x, y in zip(a, b))


def e_is_zero(a: Fpe, p: int) -> bool:
    return all(x % p == 0 for x in a)
