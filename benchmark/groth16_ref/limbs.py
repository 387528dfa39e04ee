"""Plain vector field arithmetic in PyTorch, for the reference's tables.

A frozen copy of the plain Montgomery arithmetic of the port's
ops/limbs.py (24-bit limbs in int64, a CIOS whose columns collect their
products lazily), kept here so that the reference shares no code with the
program under test.  Elements are (32, n) int64 tensors of 24-bit limbs of
canonical values below p.  Besides: words <-> limbs, exact products of
whole elements, and exact sums of products through float64 matrix
products of 16-bit limbs.
"""

import numpy as np
import torch

NLIMB, LBITS = 32, 24
MASK = (1 << LBITS) - 1
R_BITS = 768
BLOCK_ROWS = 1 << 16        # rows of one float64 product block (exact sums)


class Field:
    """Per-prime constants of the plain Montgomery product (R = 2^768)."""

    def __init__(self, p: int, device):
        self.p = p
        self.device = torch.device(device)
        self.r = (1 << R_BITS) % p
        self.ninv = (-pow(p, -1, 1 << LBITS)) % (1 << LBITS)
        self.p_l = int_to_limbs(p, self.device)[:, None]
        self.negp_l = int_to_limbs((1 << R_BITS) - p, self.device)[:, None]
        self.p1_l = int_to_limbs(p + 1, self.device)[:, None]

    def const(self, x: int, n: int) -> torch.Tensor:
        return int_to_limbs(x, self.device)[:, None].expand(NLIMB, n)


def int_to_limbs(x: int, device="cpu") -> torch.Tensor:
    return torch.tensor([(x >> (LBITS * j)) & MASK for j in range(NLIMB)],
                        dtype=torch.int64, device=device)


def limbs_to_int(col) -> int:
    return sum(int(v) << (LBITS * j) for j, v in enumerate(col.tolist()))


def carry_resolve(t: torch.Tensor, passes: int) -> torch.Tensor:
    """Lazy nonnegative limbs -> exact 24-bit limbs, mod 2^(24 * rows)."""
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
    carries = (xs + gs) ^ xs ^ gs
    return (lo + ((carries[None] >> sh) & 1)) & MASK


def _cond_sub_p(F: Field, x: torch.Tensor) -> torch.Tensor:
    s = carry_resolve(torch.cat([x + F.negp_l, torch.zeros_like(x[:1])]), 0)
    return torch.where(s[NLIMB:] > 0, s[:NLIMB], x)


def sub(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    return _cond_sub_p(F, carry_resolve(a + (MASK - b) + F.p1_l, 1))


def mont_mul(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b / R mod p (coarsely integrated operand scanning)."""
    n = a.shape[1]
    t = torch.zeros((2 * NLIMB + 1, n), dtype=torch.int64, device=a.device)
    for i in range(NLIMB):
        win = t[i:i + NLIMB]
        win.addcmul_(b, a[i:i + 1])
        m = ((t[i] & MASK) * F.ninv) & MASK
        win.addcmul_(F.p_l, m[None])
        t[i + 1] += t[i] >> LBITS
    return _cond_sub_p(F, carry_resolve(t[NLIMB:], 2)[:NLIMB])


def power_table(F: Field, base_m: int, n: int) -> torch.Tensor:
    """(32, n) Montgomery limbs of base^i, i < n, from base's Montgomery
    value, by doubling."""
    out = torch.empty((NLIMB, n), dtype=torch.int64, device=F.device)
    out[:, 0] = int_to_limbs(F.r, F.device)
    step, k = base_m, 1
    while k < n:
        m = min(k, n - k)
        out[:, k:k + m] = mont_mul(F, out[:, :m], F.const(step, m))
        step = step * step * pow(F.r, -1, F.p) % F.p
        k += m
    return out


def batch_inverse(F: Field, x: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs of nonzero values (n a power of two) -> those of
    their inverses: a product tree up, one inverse, the tree down."""
    levels = [x]
    while levels[-1].shape[1] > 1:
        v = levels[-1]
        levels.append(mont_mul(F, v[:, 0::2].contiguous(),
                               v[:, 1::2].contiguous()))
    top = limbs_to_int(levels[-1][:, 0])
    inv = F.const(pow(top, -1, F.p) * F.r * F.r % F.p, 1)
    for v in reversed(levels[:-1]):
        nxt = torch.empty_like(v)
        nxt[:, 0::2] = mont_mul(F, inv, v[:, 1::2].contiguous())
        nxt[:, 1::2] = mont_mul(F, inv, v[:, 0::2].contiguous())
        inv = nxt
    return inv


# -- exact integer arithmetic on 16-bit limbs ---------------------------------------

def words_to_u16(words: np.ndarray, device) -> torch.Tensor:
    """(24, n) int32 words (u32 bit patterns) -> (n, 48) int64 16-bit
    limbs, least significant first."""
    w = torch.from_numpy(np.ascontiguousarray(words)).to(device)
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], 1).reshape(48, -1).t()


def limbs_to_u16(x: torch.Tensor) -> torch.Tensor:
    """(32, n) 24-bit limbs -> (n, 48) 16-bit limbs."""
    lm = x.reshape(16, 2, -1)
    lo, hi = lm[:, 0], lm[:, 1]                 # 48 bits per pair
    u = torch.stack([lo & 0xFFFF, (lo >> 16) | ((hi & 0xFF) << 8),
                     hi >> 8], 1)
    return u.reshape(48, -1).t()


def product_u16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact elementwise products of (n, 48) 16-bit limbs -> (n, 96)."""
    n = a.shape[0]
    acc = torch.zeros((n, 96), dtype=torch.int64, device=a.device)
    for j in range(48):                         # each column < 48 * 2^32
        acc[:, j:j + 48] += a[:, j:j + 1] * b
    for k in range(95):
        acc[:, k + 1] += acc[:, k] >> 16
        acc[:, k] &= 0xFFFF
    return acc


def dot(x: torch.Tensor, y: torch.Tensor) -> int:
    """sum_i x_i * y_i, exactly, of (n, kx) and (n, ky) 16-bit limbs: a
    float64 matrix product a block of BLOCK_ROWS rows at a time (each
    entry a sum of at most 2^16 products below 2^32: exact in float64),
    the blocks summed in int64."""
    acc = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.int64,
                      device=x.device)
    for lo in range(0, x.shape[0], BLOCK_ROWS):
        xb = x[lo:lo + BLOCK_ROWS].to(torch.float64)
        yb = y[lo:lo + BLOCK_ROWS].to(torch.float64)
        acc += (xb.t() @ yb).to(torch.int64)
    m = acc.cpu().numpy()
    total = 0
    for s in range(m.shape[0] + m.shape[1] - 1):
        j = np.arange(max(0, s - m.shape[1] + 1), min(s, m.shape[0] - 1) + 1)
        total += int(sum(int(v) for v in m[j, s - j])) << (16 * s)
    return total
