"""Field inversion and affine normalisation on word tensors.

Turns projective points into the affine rows of the table file.  It
replaces two routes of the JAX package's models/preprocess_device.py:
the host's native batch_affine for G1 and a Python inversion per point
for G2.  Every product is a launch of the mont_mul kernel
(ops/mont_mul.py); additions and subtractions are the NTT's
(ops/ntt.py add_words / sub_words: the add/sub kernel on a card).

  * Fq: Montgomery's batch trick as a product tree.  Up the tree, pairs
    of elements multiply (an odd element rides up unchanged); the root
    is inverted by Fermat, z^(p-2), a left-to-right square-and-multiply
    chain of about 1,130 products on one lane; down the tree each child's
    inverse is its parent's inverse times its sibling.  About 3 products
    an element and 2*ceil(log2 n) + 1,130 launches a batch.  Zero
    elements ride the tree as 1 and come out as 0.
  * Fq2 / Fq3: through the norm into Fq (libff fp2.tcc / fp3.tcc
    inverse), so z = 0 maps to 0 as well.
  * affine (x, y) = (X/Z, Y/Z): the identity, Z = 0, lands on the
    all-zero row with no branch, which is the file's encoding of
    infinity (libsnark/serialization.hpp:44-67).

Elements are canonical Montgomery words, an Fq^deg element (deg, 24, *B)
coefficient 0 first.  `mul` is the Montgomery product (default mont_mul,
looked up at each call); passing ops.mont_mul.mont_mul_plain gives the
plain version of every product here.
"""

import torch

from . import limbs as L
from . import mont_mul as _mm
from .ntt import add_words, const_words, sub_words


def _mul(mul):
    return mul or _mm.mont_mul


def fermat_inverse(ctx: L.MontCtx, z: torch.Tensor, mul=None
                   ) -> torch.Tensor:
    """z^(p-2) elementwise, by left-to-right square and multiply; in the
    Montgomery domain (zR)^(p-2) chained with mont_mul is z^(p-2) R.
    z = 0 gives 0."""
    mul = _mul(mul)
    acc = z
    for bit in bin(ctx.p - 2)[3:]:
        acc = mul(ctx, acc, acc)
        if bit == "1":
            acc = mul(ctx, acc, z)
    return acc


def batch_inverse(ctx: L.MontCtx, z: torch.Tensor, mul=None
                  ) -> torch.Tensor:
    """(24, n) Montgomery words -> their inverses (0 -> 0)."""
    mul = _mul(mul)
    zero = (z == 0).all(0)
    lv = torch.where(zero, const_words(ctx.r, z.shape[1], z.device), z)
    levels = [lv]
    while lv.shape[1] > 1:
        h = lv.shape[1] // 2
        lv = torch.cat([mul(ctx, lv[:, :h].contiguous(),
                            lv[:, h:2 * h].contiguous()), lv[:, 2 * h:]], 1)
        levels.append(lv)
    inv = fermat_inverse(ctx, lv, mul)
    for lv in reversed(levels[:-1]):
        h = lv.shape[1] // 2
        # 1/a = (1/ab) * b and 1/b = (1/ab) * a, in one launch
        par = inv[:, :h]
        kids = mul(ctx, torch.cat([par, par], 1),
                   torch.cat([lv[:, h:2 * h], lv[:, :h]], 1))
        inv = torch.cat([kids, inv[:, h:]], 1)
    return torch.where(zero, torch.zeros_like(inv), inv)


class ExtWords:
    """Fq^deg = Fq[v]/(v^deg - alpha) on (deg, 24, *B) Montgomery words
    (a stack of coefficients, each (24, *B)), every product a launch of
    the Montgomery product.

    ops/field.FieldOps holds the same tower, but on (32, deg, *B) int64
    24-bit limbs with limb additions and a plain limb product: it is the
    plain version of the group kernels and never launches a kernel.  This
    class works in the 32-bit word layout that mont_mul takes, so the
    normalisation of a table row runs on the kernel with no limb
    conversion per product."""

    def __init__(self, ctx: L.MontCtx, deg: int, alpha: int, mul=None):
        self.ctx, self.deg, self.mul = ctx, deg, mul
        self.alpha = torch.from_numpy(L.int_to_words(ctx.mont(alpha)))

    def products(self, a, b):
        """Coefficient products a[k] * b[k] of two (k, 24, *B) stacks,
        in one launch."""
        a, b = torch.broadcast_tensors(a, b)
        return _mul(self.mul)(self.ctx, a.transpose(0, 1).contiguous(),
                              b.transpose(0, 1).contiguous()).transpose(0, 1)

    def times_alpha(self, a):
        """alpha * a[k] for a (k, 24, *B) stack."""
        al = self.alpha.to(a.device).reshape((1, L.NWORDS)
                                             + (1,) * (a.dim() - 2))
        return self.products(a, al)

    def total(self, coeffs):
        """Sum of (24, *B) coefficients."""
        acc = coeffs[0]
        for c in coeffs[1:]:
            acc = add_words(self.ctx, acc, c)
        return acc

    def mul_elems(self, a, b):
        """a * b for (deg, 24, *B) elements: the deg^2 coefficient
        products in one launch, the terms of degree deg and above folded
        back by alpha in a second."""
        d = self.deg
        if d == 1:
            return self.products(a, b)
        i = [x for x in range(d) for _ in range(d)]
        j = [y for _ in range(d) for y in range(d)]
        pr = self.products(a[i], b[j])
        terms = [[] for _ in range(2 * d - 1)]
        for t, (x, y) in enumerate(zip(i, j)):
            terms[x + y].append(pr[t])
        wrapped = self.times_alpha(torch.stack(
            [self.total(terms[k]) for k in range(d, 2 * d - 1)]))
        return torch.stack([
            self.total(terms[k] + ([wrapped[k]] if k < d - 1 else []))
            for k in range(d)])

    def inverse(self, z):
        """1/z for (deg, 24, n) elements through the norm (0 -> 0)."""
        d, ctx = self.deg, self.ctx
        if d == 1:
            return batch_inverse(ctx, z[0], self.mul)[None]
        if d == 2:
            sq = self.products(z, z)                      # a0^2, a1^2
            norm = sub_words(ctx, sq[0], self.times_alpha(sq[1:])[0])
            c = torch.stack([z[0], sub_words(ctx, torch.zeros_like(z[1]),
                                             z[1])])
        else:
            a0, a1, a2 = z
            t0, t1, t2, t3, t4, t5 = self.products(
                torch.stack([a0, a1, a2, a0, a0, a1]),
                torch.stack([a0, a1, a2, a1, a2, a2]))
            al = self.times_alpha(torch.stack([t5, t2]))
            c = torch.stack([sub_words(ctx, t0, al[0]),
                             sub_words(ctx, al[1], t3),
                             sub_words(ctx, t1, t4)])
            pn = self.products(torch.stack([a0, a2, a1]), c)
            norm = add_words(ctx, pn[0], self.times_alpha(
                add_words(ctx, pn[1], pn[2])[None])[0])
        ninv = batch_inverse(ctx, norm, self.mul)
        return self.products(c, ninv[None])


def to_affine_rows(cops, P: torch.Tensor, mul=None) -> torch.Tensor:
    """(3*deg, 24, n) projective points -> (n, 2*deg*24) affine rows of
    canonical Montgomery words (x coefficients, then y), the identity as
    the all-zero row."""
    deg, n = cops.deg, P.shape[-1]
    E = ExtWords(cops.F.ctx, deg, cops.F.alpha, mul)
    zi = E.inverse(P[2 * deg:])
    xy = torch.stack([P[:deg], P[deg:2 * deg]], 2)    # (deg, 24, 2, n)
    out = E.mul_elems(xy, zi[:, :, None])
    return out.permute(2, 0, 1, 3).reshape(2 * deg * L.NWORDS, n).t() \
        .contiguous()
