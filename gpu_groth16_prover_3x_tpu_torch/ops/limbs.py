"""753-bit element layout and the plain Montgomery arithmetic.

Layout.  One Fq or Fr element is 24 x 32-bit words, little-endian, in the
Montgomery domain with R = 2^768: exactly the 12 x u64 limbs of the file
format (libsnark/serialization.hpp:22-32), so loading is a bitcast.  On
the device a batch of elements is stored limb-major, ``(24, B)``
``torch.int32`` holding the u32 bit patterns, so that neighbouring CUDA
threads (lanes) read neighbouring addresses.  Values are canonical
(< p) at every kernel and module boundary.

Plain arithmetic.  PyTorch has no unsigned 64-bit products and a 32 x 32
bit product overflows int64, so the plain versions re-cut the 768 bits
into 32 limbs of 24 bits in int64, ``(32, ...)``: a limb product is below
2^48, so a CIOS column can collect all of its 64 products and carries
lazily (below 2^55) and resolve carries once at the end.  The Montgomery
product (ab + m*p) / R with m = -ab/p mod R is one integer for a given R,
so the plain CIOS here, the CUDA kernel (32-bit words) and the JAX
package's 16-bit CIOS agree bit for bit.
"""

import numpy as np
import torch

from ..curves.constants import P_A, P_B

NWORDS = 24                 # 32-bit words per element (device layout)
NLIMB = 32                  # 24-bit limbs per element (plain math)
LBITS = 24
MASK = (1 << LBITS) - 1
R_BITS = 768


# -- host-side conversions ------------------------------------------------------

def int_to_words(x: int) -> np.ndarray:
    """Python int (< 2^768) -> (24,) int32 words, little-endian."""
    return np.frombuffer(int(x).to_bytes(4 * NWORDS, "little"), "<i4").copy()


def ints_to_words(values) -> np.ndarray:
    """Python ints -> (24, n) int32, limb-major."""
    raw = b"".join(int(v).to_bytes(4 * NWORDS, "little") for v in values)
    out = np.frombuffer(raw, "<i4").reshape(len(values), NWORDS)
    return np.ascontiguousarray(out.T)


def words_to_ints(arr) -> list:
    """(24, n) words (numpy or tensor) -> list of Python ints."""
    raw = np.ascontiguousarray(np.asarray(arr).T).astype("<u4").tobytes()
    w = 4 * NWORDS
    return [int.from_bytes(raw[i:i + w], "little")
            for i in range(0, len(raw), w)]


def u64_to_words(limbs: np.ndarray) -> np.ndarray:
    """(..., 12) u64 file limbs -> (..., 24) int32 words (a bitcast)."""
    limbs = np.ascontiguousarray(limbs, dtype="<u8")
    return limbs.view("<i4").reshape(*limbs.shape[:-1], NWORDS)


def jax_rows_to_words(rows: np.ndarray) -> np.ndarray:
    """JAX rows (n, k*48) of 16-bit limbs -> (n, k*24) int32 words."""
    r = np.asarray(rows).astype("<u4")
    r = r.reshape(r.shape[0], -1, 2)
    return np.ascontiguousarray((r[..., 0] | (r[..., 1] << 16)).view("<i4"))


def jax_cols_to_words(cols: np.ndarray) -> np.ndarray:
    """JAX limb columns (48, n) of 16-bit limbs -> (24, n) int32."""
    c = np.asarray(cols).astype("<u4").reshape(NWORDS, 2, -1)
    return np.ascontiguousarray((c[:, 0] | (c[:, 1] << 16)).view("<i4"))


# -- Montgomery context -----------------------------------------------------------

class MontCtx:
    """Per-prime constants.  `prime_id` selects the prime inside the CUDA
    kernels (0 = P_A, 1 = P_B; ops/build.py constants_header)."""

    def __init__(self, p: int):
        if p not in (P_A, P_B):
            raise ValueError("only the two 753-bit primes of the cycle")
        self.p = p
        self.prime_id = 0 if p == P_A else 1
        self.r = (1 << R_BITS) % p
        self.ninv = (-pow(p, -1, 1 << LBITS)) % (1 << LBITS)
        self._limbs = {}

    def limb_const(self, name: str, device) -> torch.Tensor:
        """(32, 1) int64 limbs of p, 2^768 - p or p + 1."""
        key = (name, str(device))
        if key not in self._limbs:
            v = {"p": self.p, "negp": (1 << R_BITS) - self.p,
                 "p1": self.p + 1}[name]
            self._limbs[key] = int_to_limbs(v).to(device)[:, None]
        return self._limbs[key]

    def mont(self, x: int) -> int:
        """Standard-domain value -> Montgomery representative."""
        return x * self.r % self.p


def int_to_limbs(x: int) -> torch.Tensor:
    """Python int (< 2^768) -> (32,) int64 24-bit limbs."""
    return torch.tensor([(x >> (LBITS * j)) & MASK for j in range(NLIMB)],
                        dtype=torch.int64)


# -- words <-> limbs ----------------------------------------------------------------

def to_limbs(x: torch.Tensor) -> torch.Tensor:
    """(24, *B) int32 words -> (32, *B) int64 24-bit limbs (3 words make
    4 limbs)."""
    w = (x.to(torch.int64) & 0xFFFFFFFF).reshape((8, 3) + tuple(x.shape[1:]))
    w0, w1, w2 = w.unbind(1)
    lm = torch.stack([w0 & MASK, (w0 >> 24) | ((w1 & 0xFFFF) << 8),
                      (w1 >> 16) | ((w2 & 0xFF) << 16), w2 >> 8], 1)
    return lm.reshape((NLIMB,) + tuple(x.shape[1:]))


def from_limbs(h: torch.Tensor) -> torch.Tensor:
    """(32, *B) canonical int64 limbs -> (24, *B) int32 words."""
    lm = h.reshape((8, 4) + tuple(h.shape[1:]))
    l0, l1, l2, l3 = lm.unbind(1)
    w = torch.stack([l0 | ((l1 & 0xFF) << 24), (l1 >> 8) | ((l2 & 0xFFFF) << 16),
                     (l2 >> 16) | (l3 << 8)], 1)
    w = w.reshape((NWORDS,) + tuple(h.shape[1:]))
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


# -- plain limb arithmetic (all values canonical < p) ------------------------------

def carry_resolve(t: torch.Tensor, passes: int) -> torch.Tensor:
    """Lazy nonnegative limbs -> exact 24-bit limbs, mod 2^(24*L).

    `passes` local folds bring every limb under 2^25 (callers pick the
    count from their bound).  The remaining 0/1 carry ripple is one
    binary addition: with generate bits g (limb >= 2^24) and propagate
    bits q (low part == 2^24 - 1) packed into integers, the carries are
    the carry bits of (g|q) + g.  The carry out of the top limb is
    dropped.  L <= 62."""
    t = t.clone()
    for _ in range(passes):
        hi = t >> LBITS
        t &= MASK
        t[1:] += hi[:-1]
    lo = t & MASK
    g = t >> LBITS
    x = g | (lo == MASK).to(torch.int64)
    sh = torch.arange(t.shape[0], device=t.device).reshape(
        (-1,) + (1,) * (t.dim() - 1))
    xs = (x << sh).sum(0)
    gs = (g << sh).sum(0)
    carries = (xs + gs) ^ xs ^ gs              # bit j = carry into limb j
    return (lo + ((carries[None] >> sh) & 1)) & MASK


def _widen(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros_like(x[:1])], 0)


def _limb_shape(c: torch.Tensor, dim: int) -> torch.Tensor:
    return c.reshape((NLIMB,) + (1,) * (dim - 1))


def cond_sub_p(ctx: MontCtx, x: torch.Tensor) -> torch.Tensor:
    """x - p if x >= p else x, for x < 2p (canonical limbs)."""
    negp = _limb_shape(ctx.limb_const("negp", x.device), x.dim())
    s = carry_resolve(_widen(x + negp), 0)      # limb 32 == 1 iff x >= p
    return torch.where(s[NLIMB:] > 0, s[:NLIMB], x)


def add(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p."""
    s = carry_resolve(a + b, 0)                 # a + b < 2p < 2^768
    return cond_sub_p(ctx, s)


def sub(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p: a + (2^768 - 1 - b) + (p + 1), taken mod 2^768,
    is a - b + p in [1, 2p)."""
    p1 = _limb_shape(ctx.limb_const("p1", a.device), max(a.dim(), b.dim()))
    s = carry_resolve(a + (MASK - b) + p1, 1)
    return cond_sub_p(ctx, s)


def mont_mul_limbs(ctx: MontCtx, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Plain CIOS Montgomery product a*b/R mod p on canonical limbs.

    Operand scanning over a's 32 limbs with the reduction integrated in
    each step (coarsely integrated operand scanning).  The accumulator is
    a 65-limb buffer whose 32-limb window slides up one limb per step
    instead of shifting; each limb collects at most 64 products below
    2^48 plus one carry, so nothing overflows before the final carry
    resolve."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a = a.reshape(NLIMB, -1)
    b = b.reshape(NLIMB, -1)
    p = ctx.limb_const("p", a.device)
    t = torch.zeros((2 * NLIMB + 1, a.shape[1]), dtype=torch.int64,
                    device=a.device)
    for i in range(NLIMB):
        win = t[i:i + NLIMB]
        win.addcmul_(b, a[i:i + 1])
        m = ((t[i] & MASK) * ctx.ninv) & MASK
        win.addcmul_(p, m[None])
        t[i + 1] += t[i] >> LBITS
    r = carry_resolve(t[NLIMB:], 2)[:NLIMB]     # (ab + mp)/R < 2p
    return cond_sub_p(ctx, r).reshape(shape)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """mask (broadcast over the limb axis) True -> a, else b."""
    return torch.where(mask, a, b)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """Exact zero test of canonical limbs over the limb axis (dim 0)."""
    return (x == 0).all(dim=0)
