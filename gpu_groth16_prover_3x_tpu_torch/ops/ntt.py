"""NTT over Fr and the H-polynomial pipeline.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/ops/ntt.py (libfqfft's
radix-2 domain in the reference): radix-2 decimation in time written as
reshape/concat stages, natural order in and out, no bit-reversal gather.
Each stage multiplies the odd half by its twiddles with the mont_mul
kernel (ops/mont_mul.py) and forms E + t, E - t with plain tensor
add/sub, COL_BLOCK lanes at a time into the level's output.  Elements
are (24, n) int32 Montgomery words.  Each level's two halves are the
host spans "ntt.twiddle" and "ntt.addsub" (utils/profiling.py).

The twiddle and coset tables are built on the device by repeated
doubling with the same Montgomery product (log2 n launches), so no
O(n) Python loop runs on the host.
"""

import torch

from ..curves.constants import FieldParams, get_root_of_unity
from ..utils.profiling import span
from . import limbs as L
from .mont_mul import mont_mul


# Lanes of one block of the plain add/sub.  Its 32 int64 limbs and their
# carry temporaries take about 2.6 KB a lane, so a block holds about
# 5.5 GB of device memory whatever the width (a half level at 2^25 would
# take 44 GB, the full-width a*b - c of compute_h 87 GB).
COL_BLOCK = 1 << 21


def _blockwise(op, ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor, out):
    """out = op(a, b) on (24, ..., X) words, at most COL_BLOCK lanes at a
    time; `out` (a new tensor when None) may be a strided view, or a or b
    themselves: each block is read before it is written."""
    a, b = torch.broadcast_tensors(a, b)
    if out is None:
        out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    a3, b3 = (t.reshape(L.NWORDS, -1, t.shape[-1]) for t in (a, b))
    o3 = out.view(L.NWORDS, -1, out.shape[-1])
    B, X = o3.shape[1:]
    xs = min(X, COL_BLOCK)
    bs = max(1, COL_BLOCK // X)
    for b0 in range(0, B, bs):
        for x0 in range(0, X, xs):
            blk = (slice(None), slice(b0, b0 + bs), slice(x0, x0 + xs))
            o3[blk] = L.from_limbs(op(ctx, L.to_limbs(a3[blk]),
                                      L.to_limbs(b3[blk])))
    return out


def add_words(ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor, out=None):
    """(a + b) mod p on word tensors (plain tensor math), into `out`."""
    return _blockwise(L.add, ctx, a, b, out)


def sub_words(ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor, out=None):
    """(a - b) mod p on word tensors (plain tensor math), into `out`."""
    return _blockwise(L.sub, ctx, a, b, out)


def const_words(x: int, n: int, device) -> torch.Tensor:
    """An integer's words broadcast to (24, n), contiguous."""
    col = torch.from_numpy(L.int_to_words(x)).to(device)[:, None]
    return col.expand(L.NWORDS, n).contiguous()


def power_table(ctx: L.MontCtx, base: int, count: int, device,
                mul=mont_mul) -> torch.Tensor:
    """(24, count) Montgomery words of base^i, i = 0 .. count-1."""
    out = torch.empty((L.NWORDS, count), dtype=torch.int32, device=device)
    out[:, 0] = torch.from_numpy(L.int_to_words(ctx.r)).to(device)
    k = 1
    while k < count:
        m = min(k, count - k)
        step = const_words(ctx.mont(pow(base, k, ctx.p)), m, device)
        out[:, k:k + m] = mul(ctx, out[:, :m].contiguous(), step)
        k += m
    return out


class NttPlan:
    """Tables for one (field, n) forward + inverse NTT pair on a device."""

    def __init__(self, fp: FieldParams, n: int, device, mul=mont_mul):
        if n & (n - 1):
            raise ValueError(f"NTT size {n} is not a power of two")
        self.fp = fp
        self.n = n
        self.device = torch.device(device)
        self.ctx = L.MontCtx(fp.p)
        self.mul = mul
        p = fp.p
        omega = get_root_of_unity(fp, n)
        g = fp.multiplicative_generator
        half = max(n // 2, 1)
        self.tw_fwd = power_table(self.ctx, omega, half, device, mul)
        self.tw_inv = power_table(self.ctx, pow(omega, -1, p), half, device,
                                  mul)
        self.coset = power_table(self.ctx, g, n, device, mul)
        self.coset_inv = power_table(self.ctx, pow(g, -1, p), n, device, mul)
        self.n_inv = self.ctx.mont(pow(n, -1, p))
        # Z on the coset is the constant g^n - 1
        self.z_coset_inv = self.ctx.mont(pow(pow(g, n, p) - 1, -1, p))


def scale(plan, x: torch.Tensor, c: int) -> torch.Tensor:
    """(24, m) words times a Montgomery-form constant (`plan` gives `ctx`
    and `mul`)."""
    return plan.mul(plan.ctx, x, const_words(c, x.shape[1], x.device))


def ntt(plan: NttPlan, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """In-field DFT y_k = sum_j x_j omega^(jk) along the last axis of
    (24, n) words, or of (24, B, n) words as B transforms at once (the
    four-step NTT's column and row passes, parallel/sharded.py).  One
    `mul` launch a level either way.  `plan` gives `ctx` and `mul`; `tw`
    holds omega^j for j < n/2."""
    if x.dim() not in (2, 3) or x.shape[0] != L.NWORDS:
        raise ValueError(f"ntt: shape {tuple(x.shape)}, want (24, [B,] n)")
    ctx = plan.ctx
    n = x.shape[-1]
    B = 1 if x.dim() == 2 else x.shape[1]
    logn = n.bit_length() - 1
    v = x.reshape(L.NWORDS, B, 1, n)
    for lvl in range(logn - 1, -1, -1):
        mp, g2 = v.shape[2:]
        with span("ntt.twiddle"):
            v = v.reshape(L.NWORDS, B, mp, 2, g2 // 2)
            E, O = v[:, :, :, 0, :], v[:, :, :, 1, :]
            w = tw[:, ::(1 << lvl)][:, :mp]
            w = w[:, None, :, None].expand(L.NWORDS, B, mp, g2 // 2)
            t = plan.mul(ctx, O.reshape(L.NWORDS, -1).contiguous(),
                         w.reshape(L.NWORDS, -1).contiguous())
        with span("ntt.addsub"):
            Ec = E.reshape(L.NWORDS, B, -1)   # a copy where E is strided
            # the level's output (E + t | E - t along mp), written in place
            v = torch.empty((L.NWORDS, B, 2, mp * (g2 // 2)),
                            dtype=torch.int32, device=x.device)
            add_words(ctx, Ec, t.reshape(Ec.shape), out=v[:, :, 0])
            sub_words(ctx, Ec, t.reshape(Ec.shape), out=v[:, :, 1])
            del Ec, t
            v = v.reshape(L.NWORDS, B, 2 * mp, g2 // 2)
    return v.reshape(x.shape)


def intt(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    return scale(plan, ntt(plan, x, plan.tw_inv), plan.n_inv)


def compute_h(plan, ca, cb, cc, dft=None):
    """The witness-map H pipeline (libsnark/main.cpp:89-148): iFFT then
    coset FFT of a, b and c (basic_radix2_domain.tcc:84-89), H = a*b - c
    on the coset, divide by Z(g omega^i) = g^n - 1, a constant on the
    coset (:126-134), inverse coset FFT (:91-97).  Inputs (24, n)
    Montgomery words.

    dft(x, inverse) is the transform, by default ntt / intt on `plan`;
    parallel/prover.py passes the sharded one on a rank's (24, n/D)
    shards, with the rank's slice of the coset tables in its plan.

    Returns (h_mont, h_std): the Montgomery coefficients and the
    standard-domain values (the H MSM's scalars), both (24, n)."""
    ctx, mul = plan.ctx, plan.mul
    if dft is None:
        def dft(x, inverse):
            return intt(plan, x) if inverse else ntt(plan, x, plan.tw_fwd)

    def coset_fft(x):
        return dft(mul(ctx, x, plan.coset), False)

    a = coset_fft(dft(ca, True))
    b = coset_fft(dft(cb, True))
    h = mul(ctx, a, b)
    del a, b
    c = coset_fft(dft(cc, True))
    sub_words(ctx, h, c, out=h)
    del c
    h = mul(ctx, dft(scale(plan, h, plan.z_coset_inv), True), plan.coset_inv)
    # x*R -> x: a Montgomery product with the plain integer 1 (the output
    # is already canonical, so no extra subtract as in fp.tcc from_monty)
    h_std = mul(ctx, h, const_words(1, h.shape[1], h.device))
    return h, h_std
