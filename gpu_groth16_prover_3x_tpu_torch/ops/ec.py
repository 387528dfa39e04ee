"""Plain elliptic-curve group law: complete projective formulas, and the
bucket scan's XYZZ formulas.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/ops/ec.py and the
plain version of the group kernels (csrc/group.cu): the complete
homogeneous-projective formulas of Renes-Costello-Batina 2016 (EPRINT
2015/1060, Algorithms 1-3, general a), branch-free and correct for every
input including the identity (0 : 1 : 0), doublings and inverses.  Each
formula runs as three dependency layers of independent field products,
each layer one stacked plain Montgomery multiply (FieldOps.mul_many).

A point batch is a tensor (32, 3, deg, *batch) of canonical limbs
(X, Y, Z, each an Fq^deg element), deg 1 for G1, 2 for MNT4753 G2 (Fq2)
and 3 for MNT6753 G2 (Fq3).  The scan's run accumulator (csrc/msm_scan.cu)
is an XYZZ point (32, 4, deg, *batch), `xyzz_*` below.  The kernels take the word layout
(3*deg, 24, B) int32; `to_limb_point` / `from_limb_point` convert.
"""

from functools import lru_cache

import torch

from ..curves.constants import MNT4753, CurveParams
from . import limbs as L
from .field import fq_ops


class CurveOps:
    """Plain group arithmetic for one group (G1 or G2) of one curve."""

    def __init__(self, curve: CurveParams, group: str = "g1"):
        if group not in ("g1", "g2"):
            raise ValueError(f"group must be g1 or g2, not {group!r}")
        self.curve = curve
        self.group = group
        self.F = fq_ops(curve, group)
        self.deg = self.F.deg
        self.p = curve.fq.p
        if group == "g1":
            self.a = (curve.a,)
            self.b3 = (3 * curve.b % self.p,)
        else:
            self.a = tuple(curve.twist_a)
            self.b3 = tuple(3 * c % self.p for c in curve.twist_b)
        # kernel configuration id (csrc/field.cuh Cfg<>)
        self.cfg = (0 if curve.name == MNT4753.name else 2) + \
            (group == "g2")

    # -- constructors -----------------------------------------------------------

    def identity(self, batch, device) -> torch.Tensor:
        F = self.F
        z = F.zero(device)
        pt = torch.stack([z, F.one(device), z], 1)     # (32, 3, deg, 1)
        return pt.expand((L.NLIMB, 3, self.deg) + tuple(batch)).contiguous()

    def _am(self, t):
        return self.F.mul(self.F.const(self.a, t.device), t)

    # -- group law ------------------------------------------------------------------

    def add(self, P, Q):
        """Complete projective addition (RCB15 Algorithm 1)."""
        F, am = self.F, self._am
        X1, Y1, Z1 = P.unbind(1)
        X2, Y2, Z2 = Q.unbind(1)
        b3 = F.const(self.b3, P.device)
        m1, m2, m3, m4, m5, m6 = F.mul_many([
            (X1, X2), (Y1, Y2), (Z1, Z2),
            (F.add(X1, Y1), F.add(X2, Y2)),
            (F.add(X1, Z1), F.add(X2, Z2)),
            (F.add(Y1, Z1), F.add(Y2, Z2))])
        t3 = F.sub(m4, F.add(m1, m2))
        t4 = F.sub(m5, F.add(m1, m3))
        t5 = F.sub(m6, F.add(m2, m3))
        t2a = am(t4)
        am3 = am(m3)
        t1d = F.add(F.add(F.add(m1, m1), m1), am3)
        t2c = am(F.sub(m1, am3))
        m7, m8 = F.mul_many([(b3, m3), (b3, t4)])
        Z3a = F.add(m7, t2a)
        X3 = F.sub(m2, Z3a)
        Z3c = F.add(m2, Z3a)
        t4c = F.add(m8, t2c)
        m9, m10, m11, m12, m13, m14 = F.mul_many([
            (X3, Z3c), (t1d, t4c), (t5, t4c),
            (X3, t3), (t3, t1d), (t5, Z3c)])
        return torch.stack([F.sub(m12, m11), F.add(m9, m10),
                            F.add(m14, m13)], 1)

    def mixed_add(self, P, x2, y2, q_inf=None):
        """Complete mixed addition (RCB15 Algorithm 2, Z2 = 1).  `q_inf`
        (*batch) bool marks an infinite affine operand: the result is P."""
        F, am = self.F, self._am
        X1, Y1, Z1 = P.unbind(1)
        b3 = F.const(self.b3, P.device)
        m1, m2, m3, m4, m5, m6 = F.mul_many([
            (X1, x2), (Y1, y2), (F.add(X1, Y1), F.add(x2, y2)),
            (Z1, x2), (Z1, y2), (b3, Z1)])
        t3 = F.sub(m3, F.add(m1, m2))
        t4 = F.add(m4, X1)
        t5 = F.add(m5, Y1)
        Z3a = F.add(m6, am(t4))
        X3 = F.sub(m2, Z3a)
        Z3c = F.add(m2, Z3a)
        t2 = am(Z1)
        t1d = F.add(F.add(F.add(m1, m1), m1), t2)
        t2c = am(F.sub(m1, t2))
        m7, m8 = F.mul_many([(X3, Z3c), (b3, t4)])
        t4c = F.add(m8, t2c)
        m9, m10, m11, m12, m13 = F.mul_many([
            (t1d, t4c), (t5, t4c), (X3, t3), (t3, t1d), (t5, Z3c)])
        R = torch.stack([F.sub(m11, m10), F.add(m7, m9),
                         F.add(m13, m12)], 1)
        if q_inf is not None:
            R = torch.where(q_inf, P, R)
        return R

    def dbl(self, P):
        """Complete doubling (RCB15 Algorithm 3)."""
        F, am = self.F, self._am
        X, Y, Z = P.unbind(1)
        b3 = F.const(self.b3, P.device)
        m1, m2, m3, m4, m5, m6 = F.mul_many([
            (X, X), (Y, Y), (Z, Z), (X, Y), (X, Z), (Y, Z)])
        t3 = F.add(m4, m4)
        z2 = F.add(m5, m5)
        t2m = am(m3)
        t3c = am(F.sub(m1, t2m))
        t0c = F.add(F.add(F.add(m1, m1), m1), t2m)
        t2c = F.add(m6, m6)
        m7, m8 = F.mul_many([(b3, m3), (b3, z2)])
        Y3b = F.add(am(z2), m7)
        X3 = F.sub(m2, Y3b)
        Y3c = F.add(m2, Y3b)
        t3d = F.add(t3c, m8)
        m9, m10, m11, m12, m13 = F.mul_many([
            (X3, Y3c), (t3, X3), (t0c, t3d), (t2c, t3d), (t2c, m2)])
        Z3 = F.add(F.add(m13, m13), F.add(m13, m13))
        return torch.stack([F.sub(m10, m12), F.add(m9, m11), Z3], 1)

    def select(self, mask, P, Q):
        """mask (*batch) True -> P, else Q."""
        return L.select(mask, P, Q)

    # -- XYZZ coordinates: the bucket scan's run accumulator --------------------
    #
    # (X, Y, ZZ, ZZZ), a tensor (32, 4, deg, *batch), stands for the affine
    # point (X / ZZ, Y / ZZZ); ZZ = ZZZ = 0 is the identity.  The scan only
    # ever adds an affine row to it, which costs 10 products and no curve
    # constant (csrc/field_coop.cuh has the same formulas).

    def xyzz_identity(self, batch, device) -> torch.Tensor:
        """(1, 1, 0, 0)."""
        F = self.F
        one, z = F.one(device), F.zero(device)
        pt = torch.stack([one, one, z, z], 1)          # (32, 4, deg, 1)
        return pt.expand((L.NLIMB, 4, self.deg) + tuple(batch)).contiguous()

    def xyzz_lift(self, x, y):
        """The affine (x, y) as (x, y, 1, 1)."""
        one = self.F.one(x.device).expand_as(x)
        return torch.stack([x, y, one, one], 1)

    def xyzz_mixed_add(self, A, x2, y2):
        """madd-2008-s: A + (x2, y2) and the mask P = R = 0.  Right for
        every A but the identity and A == (x2, y2), which the mask marks
        (A == -(x2, y2) gives ZZ = ZZZ = 0 by itself)."""
        F = self.F
        X1, Y1, ZZ1, ZZZ1 = A.unbind(1)
        U2, S2 = F.mul_many([(x2, ZZ1), (y2, ZZZ1)])
        P = F.sub(U2, X1)
        R = F.sub(S2, Y1)
        PP, RR = F.mul_many([(P, P), (R, R)])
        PPP, Q, ZZ3 = F.mul_many([(P, PP), (X1, PP), (ZZ1, PP)])
        X3 = F.sub(F.sub(RR, PPP), F.add(Q, Q))
        m1, ZZZ3, m2 = F.mul_many([(Y1, PPP), (ZZZ1, PPP),
                                   (R, F.sub(Q, X3))])
        out = torch.stack([X3, F.sub(m2, m1), ZZ3, ZZZ3], 1)
        return out, F.is_zero(P) & F.is_zero(R)

    def xyzz_affine_dbl(self, x, y):
        """mdbl-2008-s-1: 2 (x, y) for an affine point with y != 0, with
        the curve's a."""
        F = self.F
        U = F.add(y, y)
        V, XX = F.mul_many([(U, U), (x, x)])
        W, S = F.mul_many([(U, V), (x, V)])
        M = F.add(F.add(F.add(XX, XX), XX), F.const(self.a, x.device))
        X3 = F.sub(F.mul(M, M), F.add(S, S))
        m1, m2 = F.mul_many([(M, F.sub(S, X3)), (W, y)])
        return torch.stack([X3, F.sub(m1, m2), V, W], 1)

    def xyzz_add_row(self, A, x2, y2, inf):
        """A + (x2, y2) for every A, `inf` (*batch) marking an infinite
        row: the madd, the doubling of the row where A equals it, the row
        where A is the identity, A where the row is infinite.  Returns the
        sum and the lanes that took the doubling."""
        out, eq = self.xyzz_mixed_add(A, x2, y2)
        acc_inf = self.F.is_zero(A[:, 2])
        dbl = eq & ~inf & ~acc_inf
        if bool(dbl.any()):
            out = torch.where(dbl, self.xyzz_affine_dbl(x2, y2), out)
        out = torch.where(acc_inf, self.xyzz_lift(x2, y2), out)
        return torch.where(inf, A, out), dbl

    def xyzz_to_proj(self, A):
        """(X ZZZ : Y ZZ : ZZ ZZZ), the identity as (0 : 1 : 0)."""
        X, Y, ZZ, ZZZ = A.unbind(1)
        pt = torch.stack(self.F.mul_many([(X, ZZZ), (Y, ZZ), (ZZ, ZZZ)]), 1)
        inf = self.F.is_zero(ZZ)
        return torch.where(inf, self.identity(inf.shape, A.device), pt)


@lru_cache(maxsize=None)
def get_curve_ops(curve: CurveParams, group: str = "g1") -> CurveOps:
    return CurveOps(curve, group)


# -- word layout (3*deg, 24, *B) int32 <-> limb points -----------------------

def to_limb_point(w: torch.Tensor, deg: int) -> torch.Tensor:
    """(ncoord*deg, 24, *B) int32 -> (32, ncoord, deg, *B) int64."""
    nc = w.shape[0] // deg
    h = L.to_limbs(w.transpose(0, 1))                 # (32, nc*deg, *B)
    return h.reshape((L.NLIMB, nc, deg) + tuple(w.shape[2:]))


def from_limb_point(h: torch.Tensor) -> torch.Tensor:
    """(32, ncoord, deg, *B) int64 -> (ncoord*deg, 24, *B) int32."""
    nc, deg = h.shape[1], h.shape[2]
    w = L.from_limbs(h.reshape((L.NLIMB, nc * deg) + tuple(h.shape[3:])))
    return w.transpose(0, 1).contiguous()
