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
from ..models.gpu_prover import DeviceInput, DeviceParams
from ..ops import limbs as L
from ..ops.ntt import NttPlan, compute_h

NBASE = 64
KS = [3 + 7 * j for j in range(NBASE)]


def rand_canon(rng, p: int, shape) -> np.ndarray:
    """(24, *shape) int32 words of values below p (the top word is drawn
    below p's top word)."""
    w = rng.integers(0, 1 << 32, size=(L.NWORDS,) + tuple(shape),
                     dtype=np.uint32)
    w[-1] %= p >> (32 * (L.NWORDS - 1))
    return w.view(np.int32)


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


def query_rows(curve, log2: int):
    """(name, rows) of each query in file order (A, B1, B2, L, H), each
    made when the caller asks for it: rows i of a query are
    k_{(i + shift) mod NBASE} * G (query_logs)."""
    base1 = multiples_rows(curve, "g1", KS)
    base2 = multiples_rows(curve, "g2", KS)
    logs = query_logs(log2)
    for name in ("A", "B1", "B2", "L", "H"):
        count, shift = logs[name]
        base = np.roll(base2 if name == "B2" else base1, -shift, 0)
        rows = np.empty((count, base.shape[1]), base.dtype)
        k = min(count, NBASE)
        rows[:k] = base[:k]
        while k < count:            # doubling copies keep the period NBASE
            n = min(k, count - k)
            rows[k:k + n] = rows[:n]
            k += n
        yield name, rows


def write_params(curve, log2: int, path: str) -> None:
    """A parameter file for a 2^log2 domain whose rows tile KS."""
    d1 = 1 << log2
    with open(path, "wb") as f:
        f.write(np.array([d1 - 1, d1], "<u8").tobytes())
        for _, rows in query_rows(curve, log2):
            f.write(rows.tobytes())


def params_arrays(curve, log2: int) -> DeviceParams:
    """The DeviceParams that load_params reads from write_params's file,
    made in memory: no file, so a 2^25 key costs its 38.65 GB once."""
    d1 = 1 << log2
    return DeviceParams(d1 - 1, d1, **dict(query_rows(curve, log2)))


def write_synthetic(curve, log2: int, workdir: str, rng):
    """Params whose rows tile known multiples k_j * G, and random inputs,
    as `<CURVE>-parameters` and `<CURVE>-input` in workdir; returns
    (params path, input path, KS, query_logs(log2), input values)."""
    params = os.path.join(workdir, f"{curve.name}-parameters")
    write_params(curve, log2, params)
    inp = os.path.join(workdir, f"{curve.name}-input")
    return params, inp, KS, query_logs(log2), write_input(curve, log2, inp,
                                                          rng)


def input_values(curve, log2: int, rng):
    """A random input for a 2^log2 domain: w, ca, cb, cc as (24, n)
    Montgomery words and r as an integer."""
    d1 = 1 << log2
    fr = curve.fr.p
    w, ca, cb, cc = (rand_canon(rng, fr, (n,)) for n in (d1 + 1, d1, d1, d1))
    return w, ca, cb, cc, int(rng.integers(1, 1 << 62))


def write_input(curve, log2: int, path: str, rng):
    """A random input file for a 2^log2 domain; returns its values
    (input_values)."""
    values = input_values(curve, log2, rng)
    with open(path, "wb") as f:
        for a in values[:4]:
            f.write(np.ascontiguousarray(a.T).tobytes())
        f.write((values[4] * R % curve.fr.p).to_bytes(96, "little"))
    return values


def input_arrays(values) -> DeviceInput:
    """input_values as the DeviceInput that load_input reads from
    write_input's file: its rows are views of the (24, n) words, which
    ProverSession.prove stages without a copy."""
    w, ca, cb, cc, r_in = values
    return DeviceInput(w.T, ca.T, cb.T, cc.T, r_in)


def known_log(ks, count: int, shift: int, scalars) -> int:
    """sum_i scalars[i] * k_{(i + shift) mod len(ks)} over the first
    `count` scalars (Python integers)."""
    acc = [0] * len(ks)
    for i, s in enumerate(scalars[:count]):
        acc[(i + shift) % len(ks)] += s
    return sum(a * k for a, k in zip(acc, ks))


TILE_COLUMNS = 1 << 20      # scalar columns summed at a time by tiled_log


def tiled_log(ks, keys, shift: int = 0) -> int:
    """known_log(ks, n, shift, scalars) of (24, n) scalar words: each word
    summed per class k_{(i + shift) mod len(ks)} in uint64 (at most
    n / len(ks) + 1 terms below 2^32 each), TILE_COLUMNS columns at a
    time, so 2^25 scalars take seconds and a few hundred MB."""
    nb = len(ks)
    keys = np.asarray(keys)
    n = keys.shape[1]
    sums = np.zeros((L.NWORDS, nb), np.uint64)
    for lo in range(0, n, TILE_COLUMNS):
        part = keys[:, lo:lo + TILE_COLUMNS].view(np.uint32)
        lead = (lo + shift) % nb            # class of the part's column 0
        w = np.zeros((L.NWORDS, -(-(lead + part.shape[1]) // nb) * nb),
                     np.uint64)
        w[:, lead:lead + part.shape[1]] = part
        sums += w.reshape(L.NWORDS, -1, nb).sum(axis=1, dtype=np.uint64)
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


def known_proof(curve, ks, logs, w, h_std, r_in: int):
    """(A, B, C) affine from the known logs: w the (24, m + 1) Montgomery
    witness words, h_std the (24, >= d) standard-domain H words.  The
    logs are linear in the scalars, so the witness's class sums are taken
    on its Montgomery words and divided by R once."""
    p = curve.fr.p
    rinv = pow(R, -1, p)

    def log_of(name, words, lo=0):
        count, shift = logs[name]
        return tiled_log(ks, words[:, lo:lo + count], shift)

    sA, sB1, sB2 = (log_of(q, w) * rinv for q in ("A", "B1", "B2"))
    sL = log_of("L", w, 2) * rinv
    sH = log_of("H", h_std)
    hg1, hg2 = HE.g1_group(curve), HE.g2_group(curve)
    g1, g2 = HE.g1_generator(curve), HE.g2_generator(curve)
    want = (hg1.to_affine(hg1.mul(sA % p, g1)),
            hg2.to_affine(hg2.mul(sB2 % p, g2)),
            hg1.to_affine(hg1.mul((sH + sL + r_in * sB1) % p, g1)))
    return tuple(tuple(x) for x in want)


def expected_proof(curve, log2: int, ks, logs, values, device):
    """(A, B, C) affine of an input from the known logs, with H from the
    kernels' pipeline on `device`."""
    w, ca, cb, cc, r_in = values
    dev_in = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (ca, cb, cc)]
    h_std = compute_h(NttPlan(curve.fr, 1 << log2, device), *dev_in)[1]
    return known_proof(curve, ks, logs, w, h_std.cpu().numpy(), r_in)
