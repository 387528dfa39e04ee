"""NTT over Fr and the H-polynomial pipeline.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/ops/ntt.py (libfqfft's
radix-2 domain in the reference): radix-2 decimation in time written as
reshape/concat stages, natural order in and out, no bit-reversal gather.
Each stage multiplies the odd half by its twiddles with the mont_mul
kernel (ops/mont_mul.py) and forms E + t and E - t with the plan's
`add_sub`: by default one launch of the add/sub kernel
(csrc/ntt_addsub.cu) that reads E where it lies and writes both halves
into the level's output.  Elements are (24, n) int32 Montgomery words.
Each level's two halves are the host spans "ntt.twiddle" and
"ntt.addsub", and each level adds 1 to the counter `#ntt.butterflies`
(utils/profiling.py).

`add_sub(ctx, a, b, sum_out, diff_out)` writes (a + b) mod p and
(a - b) mod p of canonical words into the given outputs.  A CUDA tensor
launches the kernel; a CPU tensor runs the plain version
`add_sub_plain`, ops/limbs.py add / sub on 24-bit limbs, COL_BLOCK lanes
at a time.  Nothing else falls back.  A plan built with
`add_sub=add_sub_plain` and `mul=mont_mul_plain` is all plain on any
device.

The twiddle and coset tables are built on the device by repeated
doubling with the same Montgomery product (log2 n launches), so no
O(n) Python loop runs on the host.
"""

import ctypes

import torch

from ..curves.constants import FieldParams, get_root_of_unity
from ..utils.profiling import count, span
from . import build
from . import limbs as L
from .mont_mul import mont_mul

NTT_ADDSUB = build.Kernel("ntt_addsub")

# Lanes of one block of the plain add/sub (add_sub_plain: the CPU path and
# the all-plain plan; the kernel needs no blocks).  Its 32 int64 limbs and
# their carry temporaries take about 2.6 KB a lane, so a block holds about
# 5.5 GB of device memory whatever the width (a half level at 2^25 would
# take 44 GB, the full-width a*b - c of compute_h 87 GB).
COL_BLOCK = 1 << 21


def _blockwise(ctx: L.MontCtx, a3, b3, s3, d3) -> None:
    """s3 = a3 + b3 and d3 = a3 - b3 mod p on (24, R, X) words (either
    output may be None), at most COL_BLOCK lanes at a time; an output may
    be a strided view, or a3 or b3 themselves: each block is read before
    it is written."""
    B, X = a3.shape[1:]
    xs = min(X, COL_BLOCK)
    bs = max(1, COL_BLOCK // X)
    for b0 in range(0, B, bs):
        for x0 in range(0, X, xs):
            blk = (slice(None), slice(b0, b0 + bs), slice(x0, x0 + xs))
            la, lb = L.to_limbs(a3[blk]), L.to_limbs(b3[blk])
            s = None if s3 is None else L.from_limbs(L.add(ctx, la, lb))
            if d3 is not None:
                d3[blk] = L.from_limbs(L.sub(ctx, la, lb))
            if s3 is not None:
                s3[blk] = s


def _check(a, b, outs):
    """Broadcast a and b; every output must have their shape."""
    a, b = torch.broadcast_tensors(a, b)
    if a.dim() < 2 or a.shape[0] != L.NWORDS:
        raise ValueError(f"add_sub: shape {tuple(a.shape)}, want (24, ...)")
    for o in outs:
        if o is not None and o.shape != a.shape:
            raise ValueError(f"add_sub: output shape {tuple(o.shape)}, "
                             f"want {tuple(a.shape)}")
    if all(o is None for o in outs):
        raise ValueError("add_sub: no output")
    return a, b


def add_sub_plain(ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor,
                  sum_out=None, diff_out=None) -> None:
    """The plain version of add_sub, on any device: (24, S1, ...) words
    cut into rows of S1 (one row for (24, X)), COL_BLOCK lanes at a
    time; a strided input is copied once."""
    a, b = _check(a, b, (sum_out, diff_out))
    rows = a.shape[1] if a.dim() > 2 else 1
    a3, b3 = (x.reshape(L.NWORDS, rows, -1) for x in (a, b))
    _blockwise(ctx, a3, b3,
               *(None if o is None else o.view(L.NWORDS, rows, -1)
                 for o in (sum_out, diff_out)))


def _geometry(x: torch.Tensor) -> list:
    """Word stride and the strides of n1 and n2 of a (24, [[n1,] n2,] n3)
    tensor, 0 for a missing dimension."""
    st = list(x.stride())
    return [st[0]] + [0] * (4 - x.dim()) + st[1:-1]


def add_sub(ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor,
            sum_out=None, diff_out=None) -> None:
    """(a + b) mod p into sum_out and (a - b) mod p into diff_out, either
    None to skip it, on canonical (24, [[n1,] n2,] n3) int32 words of one
    shape after broadcasting.  On a card: one launch; inputs and outputs
    may be strided views (unit stride along n3, or a copy of an input
    that has not), and an output may be an input."""
    a, b = _check(a, b, (sum_out, diff_out))
    if a.device != b.device or any(
            o is not None and o.device != a.device
            for o in (sum_out, diff_out)):
        raise ValueError("add_sub: operands on different devices")
    if a.device.type == "cpu":
        return add_sub_plain(ctx, a, b, sum_out, diff_out)
    if a.device.type != "cuda":
        raise ValueError(f"add_sub: unsupported device {a.device}")
    if a.dim() > 4:
        raise ValueError(f"add_sub: shape {tuple(a.shape)}, want "
                         "(24, [[n1,] n2,] n3)")
    a, b = (x if x.stride(-1) == 1 or x.shape[-1] == 1 else x.contiguous()
            for x in (a, b))
    geom = list(a.shape[1:])
    geom = [1] * (3 - len(geom)) + geom
    for x in (a, b, sum_out, diff_out):
        if x is None:
            geom += [0, 0, 0]
            continue
        if x.dtype != torch.int32:
            raise TypeError(f"add_sub: dtype {x.dtype}, want torch.int32")
        if x.stride(-1) != 1 and x.shape[-1] != 1:
            raise ValueError("add_sub: an output without unit stride "
                             "along its last axis")
        geom += _geometry(x)
    mode = 1 if diff_out is None else 2 if sum_out is None else 0
    build.check(build.library().g16_ntt_addsub(
        ctx.prime_id, mode, a.data_ptr(), b.data_ptr(),
        None if sum_out is None else sum_out.data_ptr(),
        None if diff_out is None else diff_out.data_ptr(),
        (ctypes.c_longlong * 15)(*geom), build.stream_ptr(a)))
    NTT_ADDSUB.launches += 1


def _new_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.empty(torch.broadcast_shapes(a.shape, b.shape),
                       dtype=torch.int32, device=a.device)


def add_words(ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor, out=None):
    """(a + b) mod p on word tensors, into `out` (new when None)."""
    out = _new_out(a, b) if out is None else out
    add_sub(ctx, a, b, sum_out=out)
    return out


def sub_words(ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor, out=None):
    """(a - b) mod p on word tensors, into `out` (new when None)."""
    out = _new_out(a, b) if out is None else out
    add_sub(ctx, a, b, diff_out=out)
    return out


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
    """Tables for one (field, n) forward + inverse NTT pair on a device.
    `mul` and `add_sub` are the plan's Montgomery product and add/sub."""

    def __init__(self, fp: FieldParams, n: int, device, mul=mont_mul,
                 add_sub=add_sub):
        if n & (n - 1):
            raise ValueError(f"NTT size {n} is not a power of two")
        self.fp = fp
        self.n = n
        self.device = torch.device(device)
        self.ctx = L.MontCtx(fp.p)
        self.mul = mul
        self.add_sub = add_sub
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
    `mul` and one `add_sub` a level either way.  `plan` gives `ctx`,
    `mul` and `add_sub`; `tw` holds omega^j for j < n/2."""
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
            # the level's output (E + t | E - t along mp), written in place
            v = torch.empty((L.NWORDS, B, 2, mp, g2 // 2),
                            dtype=torch.int32, device=x.device)
            plan.add_sub(ctx, E, t.view(E.shape), v[:, :, 0], v[:, :, 1])
            del t
            v = v.reshape(L.NWORDS, B, 2 * mp, g2 // 2)
        count("ntt.butterflies")
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
    plan.add_sub(ctx, h, c, diff_out=h)
    del c
    h = mul(ctx, dft(scale(plan, h, plan.z_coset_inv), True), plan.coset_inv)
    # x*R -> x: a Montgomery product with the plain integer 1 (the output
    # is already canonical, so no extra subtract as in fp.tcc from_monty)
    h_std = mul(ctx, h, const_words(1, h.shape[1], h.device))
    return h, h_std
