"""The port's table MSM (ops/straus.py) and its field inversion
(ops/inverse.py) on the CPU, against Python integers and the host group
law of both packages; the JAX device comparison is in the slow tier.

Inputs come from numpy generators with fixed seeds."""

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.host import ec as JHE
from gpu_groth16_prover_3x_tpu_torch.curves.constants import (MNT4753,
                                                              MNT6753, R)
from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
from gpu_groth16_prover_3x_tpu_torch.host import field as HF
from gpu_groth16_prover_3x_tpu_torch.ops import inverse as INV
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import straus as S
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_below(rng, p: int) -> int:
    return int.from_bytes(rng.bytes(96), "little") % p


def host_group(curve, group, jax=False):
    mod = JHE if jax else HE
    return (mod.g1_group(curve) if group == "g1" else mod.g2_group(curve))


def generator(curve, group):
    return (HE.g1_generator(curve) if group == "g1"
            else HE.g2_generator(curve))


def affine_words(hg, pt, p: int) -> np.ndarray:
    """Host point -> one affine row of Montgomery words (zero -> zeros)."""
    x, y = hg.to_affine(pt)
    cs = [x, y] if hg.deg == 1 else list(x) + list(y)
    return np.concatenate([L.int_to_words(c * R % p) for c in cs])


def table_rows(hg, pts, p: int, c: int = S.STRAUS_C) -> np.ndarray:
    """((2^c - 1)*n, 2*deg*24) rows: row k*n + i holds (k+1) * P_i."""
    rows, acc = [], list(pts)
    for _ in range((1 << c) - 1):
        rows.append(np.stack([affine_words(hg, a, p) for a in acc]))
        acc = [hg.add(a, b) for a, b in zip(acc, pts)]
    return np.concatenate(rows)


# -- digits -------------------------------------------------------------------

def window_offsets(c: int = S.STRAUS_C) -> set:
    return {(c * w) & 31 for w in range(S.num_windows(c))}


def test_digit_windows_straddle_every_offset_above_27():
    assert S.num_windows() == 151
    assert {28, 29, 30, 31} <= window_offsets()


@pytest.mark.parametrize("curve", [MNT4753, MNT6753],
                         ids=["MNT4753", "MNT6753"])
def test_straus_digits_match_python_ints(curve):
    rng = np.random.default_rng(5)
    r = curve.fr.p
    scalars = [0, 1, r - 1, r - 2]
    # all ones in each window that straddles two words: bits 5w .. 5w+4
    scalars += [31 << (5 * w) for w in range(S.num_windows())
                if (5 * w) & 31 > 27]
    scalars += [rand_below(rng, r) for _ in range(20)]
    keys = torch.from_numpy(L.ints_to_words(scalars))
    got = S.straus_digits(keys)
    want = [[(s >> (5 * w)) & 31 for s in scalars]
            for w in range(S.num_windows())]
    assert got.tolist() == want


# -- window sums --------------------------------------------------------------

@pytest.mark.parametrize("curve,group,n", [
    (MNT4753, "g1", 13),          # not a power of two: odd tree levels
    (MNT6753, "g1", 4),
    (MNT4753, "g2", 5),           # Fq2
    (MNT6753, "g2", 3),           # Fq3
], ids=["mnt4-g1-n13", "mnt6-g1-n4", "mnt4-g2-fq2", "mnt6-g2-fq3"])
def test_msm_straus_matches_host_scalar_multiples(curve, group, n):
    rng = np.random.default_rng(7 + n)
    r, p = curve.fr.p, curve.fq.p
    hg, jhg = host_group(curve, group), host_group(curve, group, jax=True)
    gen = generator(curve, group)
    pts = [hg.mul(rand_below(rng, r - 1) + 1, gen) for _ in range(n)]
    pts[1] = hg.zero                                  # infinity base row
    scalars = [rand_below(rng, r) for _ in range(n)]
    scalars[0] = 0
    scalars[2] = r - 1
    table = table_rows(hg, pts, p)
    got = S.msm_straus(get_curve_ops(curve, group), hg, scalars, table,
                       device="cpu")
    want = jhg.zero
    for s, pt in zip(scalars, pts):
        want = jhg.add(want, jhg.mul(s, pt))
    assert hg.equal(got, want)
    assert hg.equal(got, _port_sum(hg, scalars, pts))


def _port_sum(hg, scalars, pts):
    acc = hg.zero
    for s, pt in zip(scalars, pts):
        acc = hg.add(acc, hg.mul(s, pt))
    return acc


def test_straus_window_sums_layout_and_shape_checks():
    cops = get_curve_ops(MNT4753, "g1")
    rng = np.random.default_rng(11)
    hg = host_group(MNT4753, "g1")
    pts = [hg.mul(3 + i, generator(MNT4753, "g1")) for i in range(2)]
    table = torch.from_numpy(table_rows(hg, pts, MNT4753.fq.p))
    keys = torch.from_numpy(L.ints_to_words(
        [rand_below(rng, MNT4753.fr.p) for _ in range(2)]))
    ws = S.straus_window_sums(cops, keys, table)
    assert ws.shape == (3, 24, 151) and ws.dtype == torch.int32
    with pytest.raises(ValueError):
        S.straus_window_sums(cops, keys[:, :1], table)
    with pytest.raises(ValueError):
        S.straus_window_sums(cops, keys, table[:-1])


# -- inversion and affine normalisation ---------------------------------------

def mont_words(values, p: int) -> torch.Tensor:
    return torch.from_numpy(L.ints_to_words([v * R % p for v in values]))


def from_mont(words, p: int) -> list:
    rinv = pow(R, -1, p)
    return [v * rinv % p for v in L.words_to_ints(words.numpy())]


@pytest.mark.parametrize("curve,deg", [(MNT4753, 1), (MNT6753, 1),
                                       (MNT4753, 2), (MNT6753, 3)],
                         ids=["mnt4-fq", "mnt6-fq", "mnt4-fq2", "mnt6-fq3"])
def test_inverse_matches_host(curve, deg):
    """0 -> 0, 1, p - 1 and random elements, elementwise."""
    rng = np.random.default_rng(13 + deg)
    p, alpha = curve.fq.p, curve.non_residue
    elems = [(0,) * deg, (1,) + (0,) * (deg - 1), (p - 1,) * deg,
             (0,) * (deg - 1) + (5,)]
    elems += [tuple(rand_below(rng, p) for _ in range(deg))
              for _ in range(9)]
    z = torch.stack([mont_words([e[k] for e in elems], p)
                     for k in range(deg)])
    E = INV.ExtWords(L.MontCtx(p), deg, alpha)
    got = E.inverse(z)
    cols = [from_mont(got[k], p) for k in range(deg)]
    for i, e in enumerate(elems):
        want = ((0,) * deg if all(v == 0 for v in e)
                else HF.e_inv(e, p, alpha))
        assert tuple(col[i] for col in cols) == tuple(want)


@pytest.mark.parametrize("curve,group", [(MNT4753, "g1"), (MNT6753, "g2")],
                         ids=["mnt4-g1", "mnt6-g2"])
def test_to_affine_rows_matches_host(curve, group):
    """Projective points with random Z, and the identity (0 : 1 : 0) that
    must come out as the all-zero row."""
    rng = np.random.default_rng(17)
    p, alpha = curve.fq.p, curve.non_residue
    hg = host_group(curve, group)
    deg = hg.deg
    pts = [hg.mul(rand_below(rng, curve.fr.p), generator(curve, group))
           for _ in range(6)]
    pts[2] = hg.zero
    coords = [[] for _ in range(3 * deg)]
    for pt in pts:
        if hg.is_zero(pt):
            X, Y, Z = (0,) * deg, (1,) + (0,) * (deg - 1), (0,) * deg
        else:
            x, y = hg.to_affine(pt)
            x, y = (x, y) if deg > 1 else ((x,), (y,))
            Z = tuple(rand_below(rng, p) for _ in range(deg))
            X, Y = HF.e_mul(x, Z, p, alpha), HF.e_mul(y, Z, p, alpha)
        for k in range(deg):
            for j, v in enumerate((X, Y, Z)):
                coords[j * deg + k].append(v[k])
    P = torch.stack([mont_words(c, p) for c in coords])
    rows = INV.to_affine_rows(get_curve_ops(curve, group), P)
    want = np.stack([affine_words(hg, pt, p) for pt in pts])
    assert rows.shape == (6, 2 * deg * 24)
    assert np.array_equal(rows.numpy(), want)
    assert not rows[2].any()


# -- against the JAX device path (XLA:CPU compiles: slow tier) ----------------

@pytest.mark.slow
@pytest.mark.parametrize("curve,group,n", [(MNT4753, "g1", 13),
                                           (MNT6753, "g2", 4)],
                         ids=["mnt4-g1", "mnt6-g2"])
def test_window_sums_match_jax_straus(curve, group, n):
    """The same scalars and table through JAX ops/straus and the port:
    window by window the same group elements."""
    import jax.numpy as jnp

    from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JC
    from gpu_groth16_prover_3x_tpu.ops import msm as JM
    from gpu_groth16_prover_3x_tpu.ops.ec import get_curve_ops as jops
    from gpu_groth16_prover_3x_tpu.ops.straus import straus_window_sums
    from gpu_groth16_prover_3x_tpu_torch.ops import msm as M

    rng = np.random.default_rng(19)
    r, p = curve.fr.p, curve.fq.p
    hg = host_group(curve, group)
    pts = [hg.mul(rand_below(rng, r), generator(curve, group))
           for _ in range(n)]
    pts[0] = hg.zero
    scalars = [rand_below(rng, r) for _ in range(n)]
    scalars[1] = r - 1
    jtable = np.concatenate([
        JM.affine_points_to_rows([hg.to_affine(hg.mul(k, pt)) for pt in pts],
                                 p, hg.deg, bits=16)
        for k in range(1, 32)])
    jc = jops(JC[curve.name], group)
    jws = straus_window_sums(jc, jnp.asarray(JM.scalars_to_limbs(scalars)),
                             jnp.asarray(jtable))
    want = JM.window_sums_to_host(jc, jws, p)
    cops = get_curve_ops(curve, group)
    ws = S.straus_window_sums(
        cops, torch.from_numpy(L.ints_to_words(scalars)),
        torch.from_numpy(L.jax_rows_to_words(jtable)))
    got = M.window_sums_to_host(cops, ws)[0]
    assert len(got) == len(want) == 151
    for g, w in zip(got, want):
        assert hg.equal(M.proj_to_host(hg, g), JM.proj_to_host(hg, w))
