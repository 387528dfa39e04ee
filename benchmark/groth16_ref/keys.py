"""Proving keys with known discrete logs, and inputs, made from a seed.

A frozen copy of the idea of the port's utils/synthetic.py, with the
identity rows that keys from a real setup hold.  Every row of a query is a
known multiple of its group's generator, so each of the proof's A, B and
C is its generator times a scalar that the reference works out from the
input (groth16_ref/proof.py) without a multi-scalar multiplication:

- A, B1, B2 and L tile NBASE multiples k_j * G, k_j = 3 + 7 j: row i of
  a query is k_((i + shift) mod NBASE) * G;
- row m of A and rows 0 and m of B1 and B2 are the identity, as in keys
  from `generate_parameters` (the last variable enters only C; after the
  A/B swap the constant's B row is zero): A 1, B1 2, B2 2;
- row i of H is S_H * t^i * G, t of order PERIOD_H = 3 * 64 in Fr, so
  the H rows tile PERIOD_H points and the H query's log is S_H times
  the H polynomial at t, which the reference evaluates from the input's
  evaluations without an NTT.  t^n != 1 for every power-of-two domain n.

Words are the file's: 24 little-endian 32-bit words of the Montgomery
value x * 2^768 mod p; a key row is x then y, an input is (24, count).
Inputs are uniform words below p (the top word drawn below p's top word),
made on the run's device by one torch.Generator seeded with --seed.
"""

import numpy as np
import torch

from . import algebra
from .curves import R, CurveParams

NBASE = 64
KS = [3 + 7 * j for j in range(NBASE)]
SHIFTS = {"A": 0, "B1": 1, "L": 2, "B2": 0}
IDENTITY_ROWS = {"A": ("m",), "B1": (0, "m"), "B2": (0, "m")}
PERIOD_H = 192
S_H = 5
NWORDS = 24


def h_root(curve: CurveParams) -> int:
    """t of order exactly PERIOD_H in Fr (3 and 64 divide r - 1)."""
    p = curve.fr.p
    t = pow(curve.fr.multiplicative_generator, (p - 1) // PERIOD_H, p)
    if pow(t, PERIOD_H, p) != 1 or pow(t, PERIOD_H // 2, p) == 1 \
            or pow(t, PERIOD_H // 3, p) == 1:
        raise ValueError("the generator gives no root of order PERIOD_H")
    return t


def sizes(log2: int) -> dict:
    """d + 1 = 2^log2 = n constraints, m = n variables (the reference's
    generate_parameters): the row count of each query in file order."""
    n = 1 << log2
    return {"n": n, "d": n - 1, "m": n,
            "counts": {"A": n + 1, "B1": n + 1, "B2": n + 1, "L": n - 1,
                       "H": n - 1}}


def identity_rows(name: str, m: int) -> list:
    return [m if i == "m" else i for i in IDENTITY_ROWS.get(name, ())]


def _words(xy, p: int) -> np.ndarray:
    return np.frombuffer(algebra.point_bytes(xy, p), "<i4").copy()


def _multiples(group, ks):
    """Affine k * G for consecutive k = ks[0] + step * j, by additions."""
    step = group.mul(ks[1] - ks[0], group.gen)
    pt = group.mul(ks[0], group.gen)
    out = []
    for _ in ks:
        out.append(group.to_affine(pt))
        pt = group.add(pt, step)
    return out


def base_rows(curve: CurveParams) -> dict:
    """The distinct rows of each group: (NBASE, 48) G1 and
    (NBASE, 48 * deg) G2 multiples, and (PERIOD_H, 48) H rows."""
    q = curve.fq.p
    g1, g2 = algebra.g1(curve), algebra.g2(curve)
    rp = curve.fr.p
    t = h_root(curve)
    h = [g1.to_affine(g1.mul_gen(S_H * pow(t, j, rp) % rp))
         for j in range(PERIOD_H)]
    return {"g1": np.stack([_words(xy, q) for xy in _multiples(g1, KS)]),
            "g2": np.stack([_words(xy, q) for xy in _multiples(g2, KS)]),
            "h": np.stack([_words(xy, q) for xy in h])}


def query_rows(name: str, log2: int, base: dict) -> np.ndarray:
    """(count, width) int32 rows of one query."""
    sz = sizes(log2)
    count = sz["counts"][name]
    if name == "H":
        rows = base["h"][np.arange(count) % PERIOD_H]
    else:
        src = base["g2" if name == "B2" else "g1"]
        rows = src[(np.arange(count) + SHIFTS[name]) % NBASE]
    for i in identity_rows(name, sz["m"]):
        rows[i] = 0
    return rows


QUERIES = ("A", "B1", "B2", "L", "H")      # the params file's order


def write_params(path: str, log2: int, base: dict) -> None:
    sz = sizes(log2)
    with open(path, "wb") as f:
        f.write(np.array([sz["d"], sz["m"]], "<u8").tobytes())
        for name in QUERIES:
            f.write(query_rows(name, log2, base).tobytes())


class InputStream:
    """Inputs in a fixed order from one seed: input j is the j-th draw of a
    torch.Generator on `device` seeded with `seed`."""

    def __init__(self, curve: CurveParams, log2: int, seed: int, device):
        self.curve, self.n = curve, 1 << log2
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % (1 << 63))
        self.top = curve.fr.p >> (32 * (NWORDS - 1))

    def _words(self, count: int) -> np.ndarray:
        """(24, count) uniform words below p (the top word drawn below
        p's top word)."""
        x = torch.randint(-(1 << 31), 1 << 31, (NWORDS, count),
                          generator=self.gen, device=self.device,
                          dtype=torch.int32)
        x[-1] = torch.randint(0, self.top, (count,), generator=self.gen,
                              device=self.device, dtype=torch.int32)
        return x.cpu().numpy()

    def next(self):
        """(w (24, n + 1), ca, cb, cc (24, n) int32 words, r an integer in
        [1, r))."""
        n = self.n
        w, ca, cb, cc = (self._words(k) for k in (n + 1, n, n, n))
        raw = self._words(1).astype("<i4").tobytes()
        r = int.from_bytes(raw, "little") % (self.curve.fr.p - 1) + 1
        return w, ca, cb, cc, r


def write_input(path: str, curve: CurveParams, values) -> None:
    """An input file (generate_parameters.cpp:88-107): w, ca, cb, cc as
    rows of words, then r as its Montgomery value."""
    w, ca, cb, cc, r = values
    with open(path, "wb") as f:
        for a in (w, ca, cb, cc):
            f.write(np.ascontiguousarray(a.T).tobytes())
        f.write((r * R % curve.fr.p).to_bytes(96, "little"))
