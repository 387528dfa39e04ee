"""Synthetic proving keys with known discrete logs.

A real trusted setup at MNT4753 2^20 costs minutes of host work; these
files cost seconds.  Every query row tiles NBASE known multiples
k_j * G (k_j = 3 + 7j) of its group's generator, so each of the proof's
A, B and C is its generator times a scalar computed here from the input:
a sum of the witness (and, for C, of H's coefficients) weighted by the
k_j.  Pippenger's work does not depend on the points' values (complete
formulas), so a proof from these files costs what one from real keys of
the same size costs.

Words are the port's layout: (24, n) or (n, 24 * coords) int32,
canonical, Montgomery at R = 2^768 where the files hold Montgomery
values.
"""

import os

import numpy as np
import torch

from ..curves.constants import R
from ..host import ec as HE
from ..ops import limbs as L
from ..ops.ntt import NttPlan, compute_h

NBASE = 64
KS = [3 + 7 * j for j in range(NBASE)]


def rand_canon(rng, p: int, shape) -> np.ndarray:
    """(24, *shape) int32 words of values below p (the top word is drawn
    below p's top word)."""
    w = rng.integers(0, 1 << 32, size=(L.NWORDS,) + tuple(shape),
                     dtype=np.uint64)
    w[-1] %= p >> (32 * (L.NWORDS - 1))
    return w.astype(np.uint32).view(np.int32)


def affine_words(hg, pt, deg: int, p: int) -> np.ndarray:
    """One point's row: x then y, each coefficient as 24 Montgomery
    words."""
    x, y = hg.to_affine(pt)
    cs = [x, y] if deg == 1 else list(x) + list(y)
    return np.concatenate([L.int_to_words(c * R % p) for c in cs])


def multiples_rows(curve, group: str, ks) -> np.ndarray:
    """(len(ks), 2 * deg * 24) rows of the affine points k * G."""
    if group == "g1":
        hg, gen, deg = HE.g1_group(curve), HE.g1_generator(curve), 1
    else:
        hg, gen, deg = (HE.g2_group(curve), HE.g2_generator(curve),
                        curve.ext_degree)
    return np.stack([affine_words(hg, hg.mul(k, gen), deg, curve.fq.p)
                     for k in ks])


def query_logs(log2: int) -> dict:
    """Per query: (row count, shift); row i of a query is
    k_{(i + shift) mod NBASE} * G."""
    d1 = 1 << log2
    d, m = d1 - 1, d1
    return {"A": (m + 1, 0), "B1": (m + 1, 1), "L": (m - 1, 2),
            "H": (d, 3), "B2": (m + 1, 0)}


def write_params(curve, log2: int, path: str) -> None:
    """A parameter file for a 2^log2 domain whose rows tile KS."""
    d1 = 1 << log2
    base1 = multiples_rows(curve, "g1", KS)
    base2 = multiples_rows(curve, "g2", KS)
    logs = query_logs(log2)
    with open(path, "wb") as f:
        f.write(np.array([d1 - 1, d1], "<u8").tobytes())
        for name in ("A", "B1", "B2", "L", "H"):
            count, shift = logs[name]
            base = base2 if name == "B2" else base1
            f.write(np.roll(base, -shift, 0)[np.arange(count) % NBASE]
                    .tobytes())


def write_synthetic(curve, log2: int, workdir: str, rng):
    """Params whose rows tile known multiples k_j * G, and random inputs,
    as `<CURVE>-parameters` and `<CURVE>-input` in workdir; returns
    (params path, input path, KS, query_logs(log2), input values)."""
    params = os.path.join(workdir, f"{curve.name}-parameters")
    write_params(curve, log2, params)
    inp = os.path.join(workdir, f"{curve.name}-input")
    return params, inp, KS, query_logs(log2), write_input(curve, log2, inp,
                                                          rng)


def write_input(curve, log2: int, path: str, rng):
    """A random input file for a 2^log2 domain; returns its values
    (w, ca, cb, cc as (24, n) Montgomery words, r as an integer)."""
    d1 = 1 << log2
    fr = curve.fr.p
    w, ca, cb, cc = (rand_canon(rng, fr, (n,)) for n in (d1 + 1, d1, d1, d1))
    r_in = int(rng.integers(1, 1 << 62))
    with open(path, "wb") as f:
        for a in (w, ca, cb, cc):
            f.write(np.ascontiguousarray(a.T).tobytes())
        f.write((r_in * R % fr).to_bytes(96, "little"))
    return w, ca, cb, cc, r_in


def known_log(ks, count: int, shift: int, scalars) -> int:
    """sum_i scalars[i] * k_{(i + shift) mod len(ks)} over the first
    `count` scalars (Python integers)."""
    acc = [0] * len(ks)
    for i, s in enumerate(scalars[:count]):
        acc[(i + shift) % len(ks)] += s
    return sum(a * k for a, k in zip(acc, ks))


def tiled_log(ks, keys: np.ndarray) -> int:
    """known_log(ks, n, 0, scalars) of (24, n) scalar words, n a multiple
    of len(ks): each word summed per class in uint64 (n / len(ks) terms
    below 2^32 each), so 2^20 scalars take milliseconds."""
    nb = len(ks)
    w = np.asarray(keys).view(np.uint32).astype(np.uint64)
    sums = w.reshape(L.NWORDS, -1, nb).sum(axis=1)
    return sum(k * sum(int(sums[j, b]) << (32 * j) for j in range(L.NWORDS))
               for b, k in enumerate(ks))


def read_proof(path: str, curve):
    """A proof file's affine (A, B, C) as integers."""
    p, deg = curve.fq.p, curve.ext_degree
    rinv = pow(R, -1, p)
    with open(path, "rb") as f:
        raw = f.read()
    vals = [int.from_bytes(raw[i:i + 96], "little") * rinv % p
            for i in range(0, len(raw), 96)]
    a = (vals[0], vals[1])
    b = (tuple(vals[2:2 + deg]), tuple(vals[2 + deg:2 + 2 * deg]))
    c = tuple(vals[2 + 2 * deg:4 + 2 * deg])
    return a, b, c


def expected_proof(curve, log2: int, ks, logs, values, device):
    """(A, B, C) of an input from the known logs, with H from the kernels'
    pipeline on `device`; returns (affine points, (H words, the input's
    ca, cb, cc on the device))."""
    w, ca, cb, cc, r_in = values
    fr = curve.fr
    dev_in = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (ca, cb, cc)]
    h_k = compute_h(NttPlan(fr, 1 << log2, device), *dev_in)
    h_std = L.words_to_ints(h_k[1].cpu().numpy())
    rinv = pow(R, -1, fr.p)
    wstd = [v * rinv % fr.p for v in L.words_to_ints(w)]
    sA = known_log(ks, *logs["A"], wstd)
    sB1 = known_log(ks, *logs["B1"], wstd)
    sB2 = known_log(ks, *logs["B2"], wstd)
    sL = known_log(ks, logs["L"][0], logs["L"][1], wstd[2:])
    sH = known_log(ks, *logs["H"], h_std)
    hg1, hg2 = HE.g1_group(curve), HE.g2_group(curve)
    g1, g2 = HE.g1_generator(curve), HE.g2_generator(curve)
    want = (hg1.to_affine(hg1.mul(sA % fr.p, g1)),
            hg2.to_affine(hg2.mul(sB2 % fr.p, g2)),
            hg1.to_affine(hg1.mul((sH + sL + r_in * sB1) % fr.p, g1)))
    return tuple(tuple(x) for x in want), (h_k, dev_in)
