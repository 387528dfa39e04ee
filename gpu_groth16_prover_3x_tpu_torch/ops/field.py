"""Plain field towers: Fq, Fq2 (MNT4753 G2) and Fq3 (MNT6753 G2).

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/ops/field.py
(FpOps, ExtOps; multiexp/arith.cu in the reference).  An element of
Fq^deg = Fq[v]/(v^deg - alpha) is a tensor (32, deg, *batch) of canonical
int64 24-bit limbs (ops/limbs.py), coefficient 0 first; deg = 1 is Fq
itself.  Every result is canonical (< p), so no bound tracking is needed.

The independent products of one dependency layer of a group formula are
stacked into ONE plain Montgomery multiply (`mul_many`), as the JAX
package stacks them (FpOps.mul_batch): an EC group op is then a handful of
wide tensor passes instead of dozens of narrow ones.
"""

from functools import lru_cache

import torch

from ..curves.constants import CurveParams
from . import limbs as L


class FieldOps:
    """Fq^deg arithmetic on (32, deg, *batch) canonical limbs."""

    def __init__(self, p: int, deg: int, alpha: int):
        if deg not in (1, 2, 3):
            raise ValueError(f"unsupported extension degree {deg}")
        self.ctx = L.MontCtx(p)
        self.p = p
        self.deg = deg
        self.alpha = alpha
        self._consts = {}

    # -- constants (Montgomery form, shape (32, deg, 1)) ----------------------

    def const(self, coeffs, device) -> torch.Tensor:
        """Standard-domain coefficients -> broadcastable constant."""
        coeffs = tuple(coeffs)
        key = (coeffs, str(device))
        if key not in self._consts:
            cols = [L.int_to_limbs(self.ctx.mont(c % self.p)) for c in coeffs]
            self._consts[key] = torch.stack(cols, 1)[:, :, None].to(device)
        return self._consts[key]

    def one(self, device) -> torch.Tensor:
        return self.const((1,) + (0,) * (self.deg - 1), device)

    def zero(self, device) -> torch.Tensor:
        return self.const((0,) * self.deg, device)

    # -- arithmetic --------------------------------------------------------------

    def add(self, a, b):
        return L.add(self.ctx, a, b)

    def sub(self, a, b):
        return L.sub(self.ctx, a, b)

    def neg(self, a):
        return L.sub(self.ctx, torch.zeros_like(a), a)

    def _base_mul(self, a, b):
        return L.mont_mul_limbs(self.ctx, a, b)

    def mul_many(self, pairs) -> list:
        """Independent products a*b, all in one plain Montgomery multiply
        (Karatsuba with the non-residue folded in for deg 2 and 3)."""
        A = torch.stack(torch.broadcast_tensors(*[a for a, _ in pairs]), 1)
        B = torch.stack(torch.broadcast_tensors(*[b for _, b in pairs]), 1)
        A, B = torch.broadcast_tensors(A, B)      # (32, k, deg, *batch)
        if self.deg == 1:
            out = self._base_mul(A, B)
        elif self.deg == 2:
            a0, a1 = A[:, :, 0], A[:, :, 1]
            b0, b1 = B[:, :, 0], B[:, :, 1]
            sa = self.add(a0, a1)
            sb = self.add(b0, b1)
            t = self._base_mul(torch.stack([a0, a1, sa], 1),
                               torch.stack([b0, b1, sb], 1))
            t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
            at1 = self._base_mul(t1, self._alpha_like(t1))
            c0 = self.add(t0, at1)
            c1 = self.sub(t2, self.add(t0, t1))
            out = torch.stack([c0, c1], 2)
        else:
            a0, a1, a2 = A[:, :, 0], A[:, :, 1], A[:, :, 2]
            b0, b1, b2 = B[:, :, 0], B[:, :, 1], B[:, :, 2]
            sa = self.add(torch.stack([a0, a0, a1], 1),
                          torch.stack([a1, a2, a2], 1))
            sb = self.add(torch.stack([b0, b0, b1], 1),
                          torch.stack([b1, b2, b2], 1))
            t = self._base_mul(
                torch.cat([torch.stack([a0, a1, a2], 1), sa], 1),
                torch.cat([torch.stack([b0, b1, b2], 1), sb], 1))
            t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
            u = t[:, 3:6]                             # u01, u02, u12
            s = self.sub(u, self.add(torch.stack([t0, t0, t1], 1),
                                     torch.stack([t1, t2, t2], 1)))
            s01, s02, s12 = s[:, 0], s[:, 1], s[:, 2]
            af = self._base_mul(torch.stack([s12, t2], 1),
                                self._alpha_like(torch.stack([s12, t2], 1)))
            c = self.add(torch.stack([t0, s01, s02], 1),
                         torch.stack([af[:, 0], af[:, 1], t1], 1))
            out = c.transpose(1, 2)                   # (32, k, 3, ...)
        return list(out.unbind(1))

    def _alpha_like(self, t):
        c = L.int_to_limbs(self.ctx.mont(self.alpha)).to(t.device)
        return c.reshape((L.NLIMB,) + (1,) * (t.dim() - 1)).expand_as(t)

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def is_zero(self, a) -> torch.Tensor:
        """(32, deg, *batch) -> (*batch) bool."""
        return L.is_zero(a).all(dim=0)


@lru_cache(maxsize=None)
def field_ops(p: int, deg: int, alpha: int) -> FieldOps:
    return FieldOps(p, deg, alpha)


def fq_ops(curve: CurveParams, group: str = "g1") -> FieldOps:
    deg = 1 if group == "g1" else curve.ext_degree
    return field_ops(curve.fq.p, deg, curve.non_residue)


def fr_ops(curve: CurveParams) -> FieldOps:
    return field_ops(curve.fr.p, 1, curve.non_residue)
