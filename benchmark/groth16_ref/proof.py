"""The proof that the prover has to return, from the keys' known logs.

The prover computes (libsnark/main.cpp:219, the challenge's Groth16):

    A = sum_i w_i A_i,   B = sum_i w_i B2_i,
    C = sum_(i < d) h_i H_i + sum_i w_(2+i) L_i + r * sum_i w_i B1_i,

where h holds the coefficients of the H polynomial: the inverse coset
NTT of (A_c * B_c - C_c) / Z over the coset g * <omega> (g the field's
multiplicative generator), A_c the coset NTT of the interpolant of the
evaluations ca, and so on.  With AB - C = q Z + rem (deg rem < n) and Z
the constant g^n - 1 on the coset, h = q + rem / (g^n - 1) exactly.  So
at any t with t^n != 1:

    h(t)    = (A(t) B(t) - C(t) - rem(t)) / (t^n - 1) + rem(t) / (g^n - 1),
    h_(n-1) = rem_(n-1) / (g^n - 1),  rem_(n-1) = (1/n) sum_i e_i omega^i,

with e_i = a_i b_i - c_i and X(t) = (t^n - 1)/n * sum_i x_i lambda_i,
lambda_i = omega^i / (t - omega^i) (barycentric).  The H rows are
S_H * t^i * G (groth16_ref/keys.py), so the H part of C has the log
S_H * (h(t) - h_(n-1) t^(n-1)): sums over the input and two tables, no
NTT and no MSM.  The other queries tile known multiples, so their logs
are sums of the witness by class.

Each sum of products is exact integer arithmetic (limbs.dot, float64
matrix products of 16-bit limbs) on the given device; the points are the
generators times the logs (algebra.Group.mul_gen).  `Reference.expect`
returns the proof file's bytes.
"""

import numpy as np
import torch

from . import algebra, keys, limbs
from .curves import R, CurveParams, get_root_of_unity


def class_sum(words: np.ndarray, shift: int, nb: int = keys.NBASE) -> list:
    """Per class j, the sum of the values of columns i with
    (i + shift) mod nb == j, of (24, k) words, as integers (uint64 sums
    of 32-bit words: at most k / nb + 1 terms each)."""
    k = words.shape[1]
    lead = shift % nb
    w = np.zeros((keys.NWORDS, -(-(lead + k) // nb) * nb), np.uint64)
    w[:, lead:lead + k] = words.view(np.uint32)
    s = w.reshape(keys.NWORDS, -1, nb).sum(axis=1, dtype=np.uint64)
    return [sum(int(s[j, b]) << (32 * j) for j in range(keys.NWORDS))
            for b in range(nb)]


def word_int(words: np.ndarray, i: int) -> int:
    return int.from_bytes(words[:, i].astype("<u4").tobytes(), "little")


class Reference:
    """The expected proof of each input, for one curve and domain size."""

    def __init__(self, curve: CurveParams, log2: int, device,
                 with_top_h: bool = False):
        self.curve, self.log2 = curve, log2
        self.sz = keys.sizes(log2)
        self.device = torch.device(device)
        # the control: h's top coefficient, which the H query's d rows
        # leave out, taken into C
        self.with_top_h = with_top_h
        fr = curve.fr.p
        n = self.sz["n"]
        self.t = keys.h_root(curve)
        self.omega = get_root_of_unity(curve.fr, n)
        self.g = curve.fr.multiplicative_generator
        F = limbs.Field(fr, self.device)
        om = limbs.power_table(F, self.omega * R % fr, n)
        diff = limbs.sub(F, F.const(self.t * R % fr, n), om)
        lam = limbs.mont_mul(F, om, limbs.batch_inverse(F, diff))
        self.om16 = limbs.limbs_to_u16(om)           # R * omega^i
        self.lam16 = limbs.limbs_to_u16(lam)         # R * lambda_i
        self.g1, self.g2 = algebra.g1(curve), algebra.g2(curve)

    def logs(self, values) -> dict:
        """The discrete logs of A, B and C for an input (keys.InputStream
        values), modulo r."""
        w, ca, cb, cc, r_in = values
        fr = self.curve.fr.p
        m, n = self.sz["m"], self.sz["n"]
        rinv = pow(R, -1, fr)

        def wlog(name, cols, shift):
            sums = class_sum(cols, shift)
            total = sum(s * k for s, k in zip(sums, keys.KS))
            for i in keys.identity_rows(name, m):
                total -= word_int(cols, i) * keys.KS[(i + shift) % keys.NBASE]
            return total * rinv % fr

        a_log = wlog("A", w, keys.SHIFTS["A"])
        b1_log = wlog("B1", w, keys.SHIFTS["B1"])
        b2_log = wlog("B2", w, keys.SHIFTS["B2"])
        l_log = wlog("L", w[:, 2:2 + self.sz["counts"]["L"]],
                     keys.SHIFTS["L"])
        h_log = self.h_log(ca, cb, cc)
        return {"A": a_log, "B": b2_log,
                "C": (h_log + l_log + r_in * b1_log) % fr}

    def h_log(self, ca, cb, cc) -> int:
        fr = self.curve.fr.p
        n, t, g = self.sz["n"], self.t, self.g
        dev = self.device
        a, b, c = (limbs.words_to_u16(x, dev) for x in (ca, cb, cc))
        s_lam = {k: limbs.dot(x, self.lam16) for k, x in
                 (("a", a), ("b", b), ("c", c))}
        s_om_c = limbs.dot(c, self.om16)
        s_lam_ab = s_om_ab = 0
        step = 4 * limbs.BLOCK_ROWS              # rows of a * b at a time
        for lo in range(0, n, step):
            ab = limbs.product_u16(a[lo:lo + step], b[lo:lo + step])
            s_lam_ab += limbs.dot(ab, self.lam16[lo:lo + step])
            s_om_ab += limbs.dot(ab, self.om16[lo:lo + step])
        # the words are R * x and the tables R * lambda, R * omega^i
        r2, r3 = pow(R * R, -1, fr), pow(R ** 3, -1, fr)
        SA, SB, SC = (s_lam[k] * r2 % fr for k in "abc")
        SE = (s_lam_ab * r3 - SC) % fr
        TE = (s_om_ab * r3 - s_om_c * r2) % fr
        zt = (pow(t, n, fr) - 1) % fr
        zg_inv = pow((pow(g, n, fr) - 1) % fr, -1, fr)
        f = zt * pow(n, -1, fr) % fr
        A, B, C, rem = (f * x % fr for x in (SA, SB, SC, SE))
        h_t = ((A * B - C - rem) * pow(zt, -1, fr) + rem * zg_inv) % fr
        h_top = TE * pow(n, -1, fr) * zg_inv % fr
        if self.with_top_h:
            h_top = 0
        return keys.S_H * (h_t - h_top * pow(t, n - 1, fr)) % fr

    def points(self, values):
        """Affine (A, B, C) of an input."""
        lg = self.logs(values)
        return (self.g1.to_affine(self.g1.mul_gen(lg["A"])),
                self.g2.to_affine(self.g2.mul_gen(lg["B"])),
                self.g1.to_affine(self.g1.mul_gen(lg["C"])))

    def expect(self, values) -> bytes:
        """The proof file's bytes for an input."""
        return algebra.proof_bytes(self.curve, *self.points(values))
