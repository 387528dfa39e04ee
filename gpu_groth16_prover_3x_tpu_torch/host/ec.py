"""Exact host-side elliptic-curve groups (G1, G2) for the oracle prover.

Replaces the reference's vendored libff curve groups
(depends/libff/libff/algebra/curves/mnt753/mnt4753/mnt4753_g1.cpp etc.).
The reference stores CPU points in projective coordinates and GPU points in
Jacobian; since the serialized contract only ever sees *affine* points
(libsnark/serialization.hpp:44-54 writes affine x,y with zero encoded as
y=0), any internally-consistent coordinate system yields bit-identical
files.  We use Jacobian coordinates (zero iff Z=0), the same choice as the
reference's device code (multiexp/curves.cu:7-103).

The group is generic over the base field: G1 uses plain ints, G2 uses
extension-field tuples, with field ops chosen by extension degree.
"""

from typing import Any, List, Sequence, Tuple

from ..curves.constants import CurveParams
from . import field as F

Point = Tuple[Any, Any, Any]  # Jacobian (X, Y, Z); zero iff Z == 0


class Group:
    """Short-Weierstrass group y^2 = x^3 + a x + b over Fp or Fp^deg."""

    def __init__(self, p: int, alpha: int, deg: int, a, b):
        self.p = p
        self.alpha = alpha
        self.deg = deg
        if deg == 1:
            self.a = a if isinstance(a, int) else a[0]
            self.b = b if isinstance(b, int) else b[0]
            self.fzero, self.fone = 0, 1
            self.fadd = lambda x, y: (x + y) % p
            self.fsub = lambda x, y: (x - y) % p
            self.fneg = lambda x: (-x) % p
            self.fmul = lambda x, y: (x * y) % p
            self.fsqr = lambda x: (x * x) % p
            self.finv = lambda x: F.inv(x, p)
            self.fis_zero = lambda x: x % p == 0
            self.fequal = lambda x, y: (x - y) % p == 0
        else:
            self.a = tuple(a)
            self.b = tuple(b)
            self.fzero, self.fone = F.e_zero(deg), F.e_one(deg)
            self.fadd = lambda x, y: F.e_add(x, y, p)
            self.fsub = lambda x, y: F.e_sub(x, y, p)
            self.fneg = lambda x: F.e_neg(x, p)
            self.fmul = lambda x, y: F.e_mul(x, y, p, alpha)
            self.fsqr = lambda x: F.e_sqr(x, p, alpha)
            self.finv = lambda x: F.e_inv(x, p, alpha)
            self.fis_zero = lambda x: F.e_is_zero(x, p)
            self.fequal = lambda x, y: F.e_equal(x, y, p)
        self.zero: Point = (self.fzero, self.fone, self.fzero)

    # -- predicates ---------------------------------------------------------

    def is_zero(self, pt: Point) -> bool:
        return self.fis_zero(pt[2])

    def equal(self, pt1: Point, pt2: Point) -> bool:
        if self.is_zero(pt1) or self.is_zero(pt2):
            return self.is_zero(pt1) == self.is_zero(pt2)
        x1, y1, z1 = pt1
        x2, y2, z2 = pt2
        z1z1, z2z2 = self.fsqr(z1), self.fsqr(z2)
        if not self.fequal(self.fmul(x1, z2z2), self.fmul(x2, z1z1)):
            return False
        return self.fequal(
            self.fmul(y1, self.fmul(z2, z2z2)),
            self.fmul(y2, self.fmul(z1, z1z1)),
        )

    def is_on_curve(self, pt: Point) -> bool:
        if self.is_zero(pt):
            return True
        x, y = self.to_affine(pt)
        lhs = self.fsqr(y)
        rhs = self.fadd(
            self.fadd(self.fmul(self.fsqr(x), x), self.fmul(self.a, x)),
            self.b,
        )
        return self.fequal(lhs, rhs)

    # -- coordinate conversion ----------------------------------------------

    def from_affine(self, xy) -> Point:
        x, y = xy
        if self.deg == 1 and not isinstance(x, int):
            x, y = x[0], y[0]
        return (x, y, self.fone)

    def to_affine(self, pt: Point):
        """Jacobian -> affine (x/Z^2, y/Z^3); zero -> (0, 0).

        The (0,0) zero encoding matches write_g1/write_g2
        (libsnark/serialization.hpp:44-67).
        """
        if self.is_zero(pt):
            return (self.fzero, self.fzero)
        x, y, z = pt
        zinv = self.finv(z)
        zinv2 = self.fsqr(zinv)
        return (self.fmul(x, zinv2), self.fmul(y, self.fmul(zinv, zinv2)))

    def neg(self, pt: Point) -> Point:
        return (pt[0], self.fneg(pt[1]), pt[2])

    # -- group law ------------------------------------------------------------

    def dbl(self, pt: Point) -> Point:
        """Jacobian doubling, general a (dbl-2007-bl)."""
        if self.is_zero(pt):
            return pt
        fadd, fsub, fmul, fsqr = self.fadd, self.fsub, self.fmul, self.fsqr
        x, y, z = pt
        xx = fsqr(x)
        yy = fsqr(y)
        yyyy = fsqr(yy)
        zz = fsqr(z)
        # S = 2((X+YY)^2 - XX - YYYY)
        s = fsub(fsub(fsqr(fadd(x, yy)), xx), yyyy)
        s = fadd(s, s)
        # M = 3 XX + a ZZ^2
        m = fadd(fadd(fadd(xx, xx), xx), fmul(self.a, fsqr(zz)))
        t = fsub(fsqr(m), fadd(s, s))
        y8 = fadd(yyyy, yyyy)
        y8 = fadd(y8, y8)
        y8 = fadd(y8, y8)
        new_y = fsub(fmul(m, fsub(s, t)), y8)
        # Z3 = (Y+Z)^2 - YY - ZZ
        new_z = fsub(fsub(fsqr(fadd(y, z)), yy), zz)
        return (t, new_y, new_z)

    def add(self, pt1: Point, pt2: Point) -> Point:
        """Complete Jacobian addition (add-2007-bl with case dispatch)."""
        if self.is_zero(pt1):
            return pt2
        if self.is_zero(pt2):
            return pt1
        fadd, fsub, fmul, fsqr = self.fadd, self.fsub, self.fmul, self.fsqr
        x1, y1, z1 = pt1
        x2, y2, z2 = pt2
        z1z1 = fsqr(z1)
        z2z2 = fsqr(z2)
        u1 = fmul(x1, z2z2)
        u2 = fmul(x2, z1z1)
        s1 = fmul(y1, fmul(z2, z2z2))
        s2 = fmul(y2, fmul(z1, z1z1))
        if self.fequal(u1, u2):
            if self.fequal(s1, s2):
                return self.dbl(pt1)
            return self.zero
        h = fsub(u2, u1)
        i = fsqr(fadd(h, h))
        j = fmul(h, i)
        r = fsub(s2, s1)
        r = fadd(r, r)
        v = fmul(u1, i)
        x3 = fsub(fsub(fsqr(r), j), fadd(v, v))
        s1j = fmul(s1, j)
        y3 = fsub(fmul(r, fsub(v, x3)), fadd(s1j, s1j))
        z3 = fmul(fsub(fsub(fsqr(fadd(z1, z2)), z1z1), z2z2), h)
        return (x3, y3, z3)

    def mul(self, k: int, pt: Point) -> Point:
        """Scalar multiplication (double-and-add, exact oracle path)."""
        k = int(k)
        if k < 0:
            return self.mul(-k, self.neg(pt))
        acc = self.zero
        if k == 0 or self.is_zero(pt):
            return acc
        for bit in bin(k)[2:]:
            acc = self.dbl(acc)
            if bit == "1":
                acc = self.add(acc, pt)
        return acc

    # -- batch helpers --------------------------------------------------------

    def batch_to_affine(self, pts: Sequence[Point]) -> List:
        """Affine-normalize many points with one field inversion.

        Mirrors libff::batch_to_special_all_non_zeros
        (mnt4753_g1.cpp:485-503) generalized to tolerate zeros.
        """
        p = self.p
        if self.deg == 1:
            zs = [pt[2] % p for pt in pts]
            zinvs = F.batch_inv(zs, p)
            out = []
            for (x, y, z), zi in zip(pts, zinvs):
                if z % p == 0:
                    out.append((0, 0))
                else:
                    zi2 = zi * zi % p
                    out.append((x * zi2 % p, y * zi * zi2 % p))
            return out
        # Extension fields: norm-based batch inversion would also work; the
        # G2 vectors are comparatively small so per-point inversion is fine.
        return [self.to_affine(pt) for pt in pts]


def g1_group(curve: CurveParams) -> Group:
    return Group(curve.fq.p, curve.non_residue, 1, curve.a, curve.b)


def g2_group(curve: CurveParams) -> Group:
    return Group(
        curve.fq.p, curve.non_residue, curve.ext_degree,
        curve.twist_a, curve.twist_b,
    )


def g1_generator(curve: CurveParams) -> Point:
    g = g1_group(curve)
    return g.from_affine(curve.g1_one)


def g2_generator(curve: CurveParams) -> Point:
    g = g2_group(curve)
    return g.from_affine(curve.g2_one)
