"""The lane algorithm of csrc/field_coop.cuh, modelled word for word.

The cooperative field layer spreads one 753-bit element over T
neighbouring lanes of a warp (T = 4: 6 words a lane, T = 8: 3 words a
lane).  This file holds a small pure-Python model of exactly what the
kernels do per lane: the broadcast of one word of `a`, the per-lane
multiply-add chains into two accumulators (even and odd word positions),
the reduction factor from lane 0, the move down by one word with the
lowest word handed to the lane below, the merge of the accumulators and
the fold of the overflow words into the lane above, the ballot-style
carry resolve (generate / propagate bits, one add on the
ballot word) and the conditional subtract.  It is held against the plain
versions of the port (ops/mont_mul.mont_mul_plain, ops/limbs.add / sub)
on both primes, on seeded random canonical inputs and on the operands
that break a wrong resolve.  The fused Fq2 product of MNT4753 G2
(fq2_mul: two accumulators fed from the same broadcast words, 13 b1
unreduced) is held against the plain tower product (ops/field.FieldOps).
Every comparison is exact, and the model asserts the bounds the kernels
rely on: no lane's words wrap, the accumulators stay below their bound,
and each product ends below 2p before its one subtract.
"""

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu_torch.curves.constants import (MNT4753, P_A,
                                                             P_B)
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops.field import fq_ops
from gpu_groth16_prover_3x_tpu_torch.ops.mont_mul import mont_mul_plain

NW = 24
M32 = 0xFFFFFFFF
R = 1 << 768


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the model ----------------------------------------------------------------


class Group:
    """T lanes holding one element: lane l owns words l*W .. l*W + W - 1."""

    def __init__(self, p: int, T: int):
        assert NW % T == 0
        self.p, self.T, self.W = p, T, NW // T
        self.pl = self.split(p)
        self.notp = [[w ^ M32 for w in lane] for lane in self.pl]
        self.ninv = (-pow(p, -1, 1 << 32)) % (1 << 32)

    def split(self, x: int) -> list:
        words = [(x >> (32 * j)) & M32 for j in range(NW)]
        return [words[l * self.W:(l + 1) * self.W] for l in range(self.T)]

    def join(self, lanes: list) -> int:
        words = [w for lane in lanes for w in lane]
        assert all(0 <= w <= M32 for w in words)
        return sum(w << (32 * j) for j, w in enumerate(words))

    # one lane's add-with-carry chain over its W words
    @staticmethod
    def _chain(a, b, cin):
        out, c = [], cin
        for x, y in zip(a, b):
            s = x + y + c
            out.append(s & M32)
            c = s >> 32
        return out, c

    def resolve(self, r: list, g: list, cin0: int):
        """Carries between lanes.  r[l]: lane l's W words after its local
        add, g[l]: the carry out of that add.  Lane l propagates when all
        its words are ones.  The two ballots give the words G and Q; with
        X = G | Q the carries into the lanes are the carry bits of
        X + G + cin0, and bit T is the carry out of the group."""
        T = self.T
        G = sum(g[l] << l for l in range(T))
        Q = sum(int(all(w == M32 for w in r[l])) << l for l in range(T))
        assert G & Q == 0
        X = G | Q
        cvec = (X + G + cin0) ^ X ^ G
        out = []
        for l in range(T):
            words, _ = self._chain(r[l], [0] * self.W, (cvec >> l) & 1)
            out.append(words)
        return out, (cvec >> T) & 1

    def coop_add(self, a: list, b: list, cin0: int):
        """a + b + cin0 over the group: (low 768 bits, carry out)."""
        r, g = [], []
        for l in range(self.T):
            words, c = self._chain(a[l], b[l], 0)
            r.append(words)
            g.append(c)
        return self.resolve(r, g, cin0)

    def cond_sub_p(self, s: list) -> list:
        """s - p if s >= p else s, as s + ~p + 1 with the carry out as the
        vote."""
        d, ge = self.coop_add(s, self.notp, 1)
        return d if ge else s

    def add(self, a: list, b: list) -> list:
        s, c = self.coop_add(a, b, 0)
        assert c == 0                       # a + b < 2p < 2^768
        return self.cond_sub_p(s)

    def sub(self, a: list, b: list) -> list:
        d, no_borrow = self.coop_add(
            a, [[w ^ M32 for w in lane] for lane in b], 1)
        back = [[0 if no_borrow else w for w in lane] for lane in self.pl]
        return self.coop_add(d, back, 0)[0]

    # -- products ----------------------------------------------------------

    def _acc(self) -> tuple:
        """One product's accumulator in every lane: two arrays, so that
        every 64-bit product lands on a fixed pair of words.  `ev` holds
        positions 0 .. W+1 and takes the products of the lane's even words
        (pairs (0,1), (2,3), ...), `od` holds positions 1 .. W+1 and takes
        the odd ones (pairs (1,2), (3,4), ...).  Moving down one word swaps
        their roles."""
        T, W = self.T, self.W
        return ([[0] * (W + 2) for _ in range(T)],
                [[0] * (W + 1) for _ in range(T)])

    def _mad(self, acc: list, x: int, ys: list, first: int) -> None:
        """One carry chain of lo:hi pairs, ending in the words above; no
        word may wrap."""
        c, j = 0, first
        while j < self.W:
            k = j - first                   # index of the pair's low word
            s = acc[k] + ((x * ys[j]) & M32) + c
            acc[k], c = s & M32, s >> 32
            s = acc[k + 1] + ((x * ys[j]) >> 32) + c
            acc[k + 1], c = s & M32, s >> 32
            j += 2
        for k in range(j - first, len(acc)):
            s = acc[k] + c
            acc[k], c = s & M32, s >> 32
        assert c == 0

    def _row(self, acc: tuple, x: int, ys: list) -> None:
        """acc += x * ys: x is one broadcast word, ys each lane's words."""
        ev, od = acc
        for l in range(self.T):
            self._mad(ev[l], x, ys[l], 0)
            self._mad(od[l], x, ys[l], 1)

    def _reduce(self, acc: tuple) -> None:
        """acc += m p with m from lane 0 (shuffle), then down one word: a
        lane's lowest word goes to the lane below (shuffle down, the top
        lane takes 0) and enters at position W - 1; `od` (positions 1 ..)
        becomes the new `ev` and takes the old ev[1] at position 0 in one
        carry chain; the old ev[2 ..] is the new `od`."""
        T, W = self.T, self.W
        ev, od = acc
        m = (ev[0][0] * self.ninv) & M32
        self._row(acc, m, self.pl)
        assert ev[0][0] == 0
        ups = [ev[l + 1][0] if l + 1 < T else 0 for l in range(T)]
        for l in range(T):
            add = [ev[l][1]] + [0] * W
            add[W - 1] += ups[l]
            new_ev, c = self._chain(od[l] + [0], add + [0], 0)
            assert c == 0
            ev[l], od[l] = new_ev, ev[l][2:] + [0]

    def _value(self, acc: tuple) -> int:
        """The integer an accumulator stands for, every lane's overflow
        words at their place."""
        ev, od = acc
        return sum((self._words(ev[l]) + (self._words(od[l]) << 32))
                   << (32 * self.W * l) for l in range(self.T))

    @staticmethod
    def _words(ws: list) -> int:
        return sum(w << (32 * j) for j, w in enumerate(ws))

    def _finish(self, acc: tuple) -> list:
        """Merge the two arrays, fold each lane's two overflow words into
        the lane above (shuffle up), resolve the remaining carries, and
        subtract p once: the sum must be below 2p."""
        T, W = self.T, self.W
        ev, od = acc
        t = []
        for l in range(T):
            words, c = self._chain(ev[l], [0] + od[l], 0)
            assert c == 0
            t.append(words)
        r, g = [], []
        for l in range(T):
            o = t[l - 1][W:W + 2] if l else [0, 0]
            words, c = self._chain(t[l][:W], o + [0] * (W - 2), 0)
            r.append(words)
            g.append(c)
        assert t[T - 1][W] == 0 and t[T - 1][W + 1] == 0
        s, c = self.resolve(r, g, 0)
        assert c == 0 and self.join(s) < 2 * self.p
        return self.cond_sub_p(s)

    def mul(self, a: list, b: list) -> list:
        """Cooperative CIOS: a*b/R mod p.  Per word a_i (shuffle from the
        lane that holds it) one product row, then the reduction."""
        acc = self._acc()
        for src in range(self.T):           # the lane that holds a_i
            for k in range(self.W):
                self._row(acc, a[src][k], b)
                self._reduce(acc)
                assert self._value(acc) < 2 * self.p
        return self._finish(acc)

    def times(self, a: list, K: int) -> list:
        """K a as a 768-bit integer, not reduced: each lane multiplies its
        words, its carry word goes to the lane above (shuffle up), and one
        resolve finishes."""
        T, W = self.T, self.W
        loc, cw = [], []
        for l in range(T):
            words, c = [], 0
            for w in a[l]:
                x = w * K + c
                words.append(x & M32)
                c = x >> 32
            loc.append(words)
            cw.append(c)
        r, g = [], []
        for l in range(T):
            cin = cw[l - 1] if l else 0
            words, c = self._chain(loc[l], [cin] + [0] * (W - 1), 0)
            r.append(words)
            g.append(c)
        s, c = self.resolve(r, g, 0)
        assert c == 0 and cw[T - 1] == 0    # K a < 2^768
        return s

    def mul_fq2(self, a: tuple, b: tuple, K: int) -> tuple:
        """The fused product over Fq[v]/(v^2 - K): c0 = a0 b0 + a1 (K b1)
        and c1 = a0 b1 + a1 b0 as two accumulators of one loop.  Per word
        i the two broadcast words a0_i and a1_i feed both; each takes its
        own m.  K b1 stays unreduced, so the accumulators stay below
        (K + 2) p and 3 p."""
        (a0, a1), (b0, b1) = a, b
        kb1 = self.times(b1, K)
        assert self.join(kb1) == K * self.join(b1)
        acc0, acc1 = self._acc(), self._acc()
        for src in range(self.T):
            for k in range(self.W):
                x0, x1 = a0[src][k], a1[src][k]     # one shuffle each
                self._row(acc0, x1, kb1)
                self._row(acc0, x0, b0)
                self._reduce(acc0)
                self._row(acc1, x1, b0)
                self._row(acc1, x0, b1)
                self._reduce(acc1)
                assert self._value(acc0) < (K + 2) * self.p
                assert self._value(acc1) < 3 * self.p
        return self._finish(acc0), self._finish(acc1)


# -- operands -----------------------------------------------------------------


def edge_operands(p: int, T: int) -> list:
    """0, 1, p - 1, R mod p, all-ones words on each lane border, and
    values whose add or subtract ripples through every lane."""
    W = NW // T
    out = [0, 1, 2, p - 1, p - 2, R % p, (p - 1) // 2, (p + 1) // 2]
    for l in range(1, T):
        lo, hi = 32 * (l * W - 1), 32 * (l * W + 1)
        if hi >= 736:
            hi = 736
        out.append(((1 << hi) - 1) ^ ((1 << lo) - 1))   # straddles border l
        out.append((1 << (32 * l * W)) - 1)             # ones below border l
        out.append(1 << (32 * l * W))                   # one above border l
    out += [(1 << 736) - 1, 1 << 736, (1 << 752) - 1, 1 << 752,
            p - (1 << 736), p - ((1 << 736) - 1)]
    assert all(0 <= v < p for v in out)
    return out


def random_operands(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, NW), dtype=np.uint64)
    words[:, -1] %= p >> 736
    return [int.from_bytes(w.astype("<u4").tobytes(), "little")
            for w in words]


def pairs(p: int, T: int, seed: int):
    e = edge_operands(p, T)
    xs = [x for x in e for _ in e] + random_operands(p, 24, seed)
    ys = [y for _ in e for y in e] + random_operands(p, 24, seed + 1)
    return xs, ys


def plain(op: str, ctx: L.MontCtx, xs: list, ys: list) -> list:
    a = torch.from_numpy(L.ints_to_words(xs))
    b = torch.from_numpy(L.ints_to_words(ys))
    if op == "mul":
        out = mont_mul_plain(ctx, a, b)
    else:
        fn = L.add if op == "add" else L.sub
        out = L.from_limbs(fn(ctx, L.to_limbs(a), L.to_limbs(b)))
    return L.words_to_ints(out.numpy())


def fq2_cases(p: int, seed: int) -> list:
    """(a0, a1, b0, b1): seeded canonical operands, every coefficient at
    p - 1 (the largest accumulators), zero, one (1 and R mod p, the
    Montgomery one), and a = b."""
    r = random_operands(p, 48, seed)
    cases = [tuple(r[i:i + 4]) for i in range(0, 48, 4)]
    m, one = p - 1, R % p
    cases += [(m, m, m, m), (m, 0, 0, m), (0, m, m, 0), (0, 0, 0, 0),
              (0, 0, m, m), (one, 0, r[0], r[1]), (r[2], r[3], one, 0),
              (1, 0, 1, 0), (0, 1, 0, 1), (m, m, 0, 0)]
    cases += [(a0, a1, a0, a1) for a0, a1, _, _ in cases[:4] + cases[-10:]]
    return cases


def fq2_plain(cases: list) -> list:
    """The port's plain tower product over MNT4753 G2's Fq2."""
    def el(i, j):
        return torch.stack([L.to_limbs(torch.from_numpy(
            L.ints_to_words([c[k] for c in cases]))) for k in (i, j)], 1)
    out = fq_ops(MNT4753, "g2").mul(el(0, 1), el(2, 3))
    c0, c1 = (L.words_to_ints(L.from_limbs(out[:, k]).numpy())
              for k in (0, 1))
    return list(zip(c0, c1))


def times_operands(p: int, T: int, K: int) -> list:
    """Edge operands, and x = (2^(32 W (l + 1)) + e) / K for each lane l:
    K x has lanes 1 .. l zero, so that in the unreduced K x lane 1
    generates and lanes 2 .. l propagate to lane l + 1."""
    W = NW // T
    out = edge_operands(p, T)
    for l in range(1, T - 1):
        top = 1 << (32 * W * (l + 1))
        out.append((top + (-top) % K) // K)
    return out


PRIMES = [pytest.param(P_A, id="P_A"), pytest.param(P_B, id="P_B")]


# -- the tests ----------------------------------------------------------------


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("p", PRIMES)
def test_lane_model_vs_plain(p, T, op):
    """Every edge operand against every other, plus random pairs, through
    the lane model and through the port's plain version."""
    grp = Group(p, T)
    xs, ys = pairs(p, T, 11)
    if op == "mul":                   # the product model is slow: thin out
        xs, ys = xs[::7] + xs[-24:], ys[::7] + ys[-24:]
    want = plain(op, L.MontCtx(p), xs, ys)
    fn = getattr(grp, op)
    got = [grp.join(fn(grp.split(x), grp.split(y))) for x, y in zip(xs, ys)]
    assert got == want


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("p", PRIMES)
def test_lane_model_vs_integers(p, T):
    """The same model against exact integers, so that model and plain
    version cannot share a fault."""
    grp = Group(p, T)
    xs, ys = pairs(p, T, 13)
    xs, ys = xs[::5], ys[::5]
    rinv = pow(R, -1, p)
    for x, y in zip(xs, ys):
        a, b = grp.split(x), grp.split(y)
        assert grp.join(grp.add(a, b)) == (x + y) % p
        assert grp.join(grp.sub(a, b)) == (x - y) % p
        assert grp.join(grp.mul(a, b)) == x * y * rinv % p


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("p", PRIMES)
def test_resolve_ripples_through_every_lane(p, T):
    """A carry that enters at lane 0 and leaves at the top lane, a borrow
    that does the same, and a propagate word beside a generate word."""
    grp = Group(p, T)
    W = grp.W
    ones = [[M32] * W for _ in range(T)]
    zero = [[0] * W for _ in range(T)]
    one = grp.split(1)
    s, c = grp.coop_add(ones, one, 0)             # 2^768 - 1 + 1
    assert (grp.join(s), c) == (0, 1)
    s, c = grp.coop_add(ones, zero, 1)            # the same by carry-in
    assert (grp.join(s), c) == (0, 1)
    s, c = grp.coop_add(zero, ones, 1)            # 0 - 0: no borrow
    assert (grp.join(s), c) == (0, 1)
    s, c = grp.coop_add(zero, [[w ^ M32 for w in lane] for lane in one], 1)
    assert (grp.join(s), c) == (R - 1, 0)         # 0 - 1: borrow everywhere
    for l in range(T - 1):
        # lane l generates, lanes above it are all ones: the carry runs
        # to the top; one word short of all ones it stops
        a = [[0] * W for _ in range(T)]
        a[l] = [M32] * W
        for u in range(l + 1, T):
            a[u] = [M32] * W
        b = grp.split(1 << (32 * W * l))
        s, c = grp.coop_add(a, b, 0)
        assert grp.join(s) + (c << 768) == grp.join(a) + grp.join(b)
        assert c == 1
        a[T - 1][0] ^= 1
        s, c = grp.coop_add(a, b, 0)
        assert grp.join(s) + (c << 768) == grp.join(a) + grp.join(b)
        assert c == 0
    assert grp.join(grp.sub(grp.split(0), one)) == p - 1
    assert grp.join(grp.add(grp.split(p - 1), one)) == 0


@pytest.mark.parametrize("T", [4, 8])
def test_fused_fq2_product_vs_plain(T):
    """MNT4753 G2's product over Fq2 (P_B, non-residue 13) through the
    fused lane model, against the port's plain tower product and against
    exact integers."""
    p, K = P_B, MNT4753.non_residue
    grp = Group(p, T)
    cases = fq2_cases(p, 17)
    rinv = pow(R, -1, p)
    for (a0, a1, b0, b1), want in zip(cases, fq2_plain(cases)):
        c0, c1 = grp.mul_fq2((grp.split(a0), grp.split(a1)),
                             (grp.split(b0), grp.split(b1)), K)
        got = (grp.join(c0), grp.join(c1))
        assert got == want
        assert got == ((a0 * b0 + K * a1 * b1) * rinv % p,
                       (a0 * b1 + a1 * b0) * rinv % p)


@pytest.mark.parametrize("T", [4, 8])
def test_times_ripples_through_every_lane(T):
    """The unreduced 13 b1 of the fused product: exact on the edge
    operands and on carries that run from lane 1 through every lane."""
    p, K = P_B, MNT4753.non_residue
    grp = Group(p, T)
    for x in times_operands(p, T, K):
        assert grp.join(grp.times(grp.split(x), K)) == K * x
