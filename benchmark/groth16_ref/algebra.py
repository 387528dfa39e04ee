"""Exact field and group arithmetic of the reference, on Python integers.

A frozen copy of the port's host/field.py and host/ec.py, cut to what the
reference needs: short-Weierstrass groups over Fq (G1) and over Fq2 or
Fq3 (G2) in Jacobian coordinates, and a fixed-base multiplier for the
generators.  Elements are in the standard (non-Montgomery) domain;
Montgomery form appears only where bytes are written (`point_bytes`).
"""

from .curves import R, CurveParams


def _ext_mul(a, b, p: int, alpha: int):
    if len(a) == 2:
        a0, a1 = a
        b0, b1 = b
        t0, t1 = a0 * b0, a1 * b1
        return ((t0 + alpha * t1) % p,
                ((a0 + a1) * (b0 + b1) - t0 - t1) % p)
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
    s01 = (a0 + a1) * (b0 + b1) - t0 - t1
    s02 = (a0 + a2) * (b0 + b2) - t0 - t2
    s12 = (a1 + a2) * (b1 + b2) - t1 - t2
    return ((t0 + alpha * s12) % p, (s01 + alpha * t2) % p,
            (s02 + t1) % p)


def _ext_inv(a, p: int, alpha: int):
    if len(a) == 2:
        a0, a1 = a
        ninv = pow((a0 * a0 - alpha * a1 * a1) % p, -1, p)
        return (a0 * ninv % p, (-a1) * ninv % p)
    a0, a1, a2 = a
    c0 = (a0 * a0 - alpha * a1 * a2) % p
    c1 = (alpha * a2 * a2 - a0 * a1) % p
    c2 = (a1 * a1 - a0 * a2) % p
    t6 = pow((a0 * c0 + alpha * (a2 * c1 + a1 * c2)) % p, -1, p)
    return (t6 * c0 % p, t6 * c1 % p, t6 * c2 % p)


class Group:
    """y^2 = x^3 + a x + b over Fq (deg 1) or Fq^deg (v^deg = alpha)."""

    def __init__(self, p: int, alpha: int, deg: int, a, b, gen):
        self.p, self.deg = p, deg
        if deg == 1:
            self.a = a
            self.zero_f, self.one_f = 0, 1
            self.add_f = lambda x, y: (x + y) % p
            self.sub_f = lambda x, y: (x - y) % p
            self.mul_f = lambda x, y: x * y % p
            self.inv_f = lambda x: pow(x, -1, p)
            self.is_zero_f = lambda x: x % p == 0
        else:
            self.a = tuple(a)
            self.zero_f, self.one_f = (0,) * deg, (1,) + (0,) * (deg - 1)
            self.add_f = lambda x, y: tuple((u + v) % p for u, v in zip(x, y))
            self.sub_f = lambda x, y: tuple((u - v) % p for u, v in zip(x, y))
            self.mul_f = lambda x, y: _ext_mul(x, y, p, alpha)
            self.inv_f = lambda x: _ext_inv(x, p, alpha)
            self.is_zero_f = lambda x: all(u % p == 0 for u in x)
        self.zero = (self.zero_f, self.one_f, self.zero_f)
        self.gen = (gen[0], gen[1], self.one_f)
        self._table = None

    def is_zero(self, pt) -> bool:
        return self.is_zero_f(pt[2])

    def to_affine(self, pt):
        """Jacobian -> affine; the zero point -> (0, 0), as the file has it."""
        if self.is_zero(pt):
            return (self.zero_f, self.zero_f)
        x, y, z = pt
        zi = self.inv_f(z)
        zi2 = self.mul_f(zi, zi)
        return (self.mul_f(x, zi2), self.mul_f(y, self.mul_f(zi, zi2)))

    def dbl(self, pt):
        """dbl-2007-bl, general a."""
        if self.is_zero(pt):
            return pt
        add, sub, mul = self.add_f, self.sub_f, self.mul_f
        x, y, z = pt
        xx, yy, zz = mul(x, x), mul(y, y), mul(z, z)
        yyyy = mul(yy, yy)
        s = sub(sub(mul(add(x, yy), add(x, yy)), xx), yyyy)
        s = add(s, s)
        m = add(add(add(xx, xx), xx), mul(self.a, mul(zz, zz)))
        t = sub(mul(m, m), add(s, s))
        y8 = add(yyyy, yyyy)
        y8 = add(y8, y8)
        y8 = add(y8, y8)
        yz = add(y, z)
        return (t, sub(mul(m, sub(s, t)), y8), sub(sub(mul(yz, yz), yy), zz))

    def add(self, p1, p2):
        """add-2007-bl with the doubling and inverse cases."""
        if self.is_zero(p1):
            return p2
        if self.is_zero(p2):
            return p1
        add, sub, mul = self.add_f, self.sub_f, self.mul_f
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        z1z1, z2z2 = mul(z1, z1), mul(z2, z2)
        u1, u2 = mul(x1, z2z2), mul(x2, z1z1)
        s1, s2 = mul(y1, mul(z2, z2z2)), mul(y2, mul(z1, z1z1))
        if self.is_zero_f(sub(u1, u2)):
            return self.dbl(p1) if self.is_zero_f(sub(s1, s2)) else self.zero
        h = sub(u2, u1)
        i = mul(add(h, h), add(h, h))
        j = mul(h, i)
        r = sub(s2, s1)
        r = add(r, r)
        v = mul(u1, i)
        x3 = sub(sub(mul(r, r), j), add(v, v))
        s1j = mul(s1, j)
        y3 = sub(mul(r, sub(v, x3)), add(s1j, s1j))
        z12 = add(z1, z2)
        z3 = mul(sub(sub(mul(z12, z12), z1z1), z2z2), h)
        return (x3, y3, z3)

    def mul(self, k: int, pt):
        """Double-and-add (k >= 0)."""
        acc = self.zero
        for bit in bin(k)[2:]:
            acc = self.dbl(acc)
            if bit == "1":
                acc = self.add(acc, pt)
        return acc

    def mul_gen(self, k: int):
        """k * generator by a fixed-base table of 4-bit windows: one
        addition a nonzero window, no doubling."""
        if self._table is None:
            table, base = [], self.gen
            for _ in range(192):                    # 768 bits / 4
                row = [self.zero, base]
                for _ in range(14):
                    row.append(self.add(row[-1], base))
                table.append(row)
                base = self.add(row[-1], base)      # 16 * base
            self._table = table
        acc = self.zero
        w = 0
        while k:
            if k & 15:
                acc = self.add(acc, self._table[w][k & 15])
            k >>= 4
            w += 1
        return acc


def g1(curve: CurveParams) -> Group:
    return Group(curve.fq.p, curve.non_residue, 1, curve.a, curve.b,
                 curve.g1_one)


def g2(curve: CurveParams) -> Group:
    return Group(curve.fq.p, curve.non_residue, curve.ext_degree,
                 curve.twist_a, curve.twist_b, curve.g2_one)


def fq_bytes(x: int, p: int) -> bytes:
    """The file's element: 12 little-endian u64 limbs of x * R mod p."""
    return (x * R % p).to_bytes(96, "little")


def point_bytes(xy, p: int) -> bytes:
    """An affine point as the file writes it, coefficients of an extension
    element constant first; the zero point is (0, 0)."""
    out = b""
    for c in xy:
        for v in (c,) if isinstance(c, int) else c:
            out += fq_bytes(v, p)
    return out


def proof_bytes(curve: CurveParams, a, b, c) -> bytes:
    """A proof file: A (G1), B (G2), C (G1), each affine."""
    p = curve.fq.p
    return point_bytes(a, p) + point_bytes(b, p) + point_bytes(c, p)
