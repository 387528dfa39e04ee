"""Port group law (ops/ec.py, the plain version of the group kernels in
ops/group_kernels.py) against the JAX package's exact host group law
(host/ec.py), for G1 of both curves and G2 over Fq2 and Fq3.

Projective coordinates are not unique, so results are compared as
points.  The JAX ops/ec.CurveOps leg (XLA:CPU) is in the slow tier."""

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import MNT4753, MNT6753, R
from gpu_groth16_prover_3x_tpu.host import ec as JHE
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.ops.group_kernels import (ec_add, ec_dbl,
                                                               ec_mixed_add)
from gpu_groth16_prover_3x_tpu_torch.ops.msm import (proj_to_host,
                                                     window_sums_to_host)

GROUPS = [(MNT4753, "g1"), (MNT4753, "g2"), (MNT6753, "g1"),
          (MNT6753, "g2")]
IDS = ["mnt4-g1", "mnt4-g2", "mnt6-g1", "mnt6-g2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def host_group(curve, group):
    if group == "g1":
        return JHE.g1_group(curve), JHE.g1_generator(curve)
    return JHE.g2_group(curve), JHE.g2_generator(curve)


def coeffs(v, deg):
    return [v] if deg == 1 else list(v)


def to_words(pts, hg, deg, p, ncoord=3):
    """Host points -> (ncoord*deg, 24, n) Montgomery words: affine
    (x, y, 1), the identity (0, 1, 0); ncoord=2 gives affine (x, y) with
    the identity as (0, 0)."""
    cols = []
    for pt in pts:
        if hg.is_zero(pt):
            x, y, z = [0] * deg, [1] + [0] * (deg - 1), [0] * deg
            if ncoord == 2:
                y = [0] * deg
        else:
            ax, ay = hg.to_affine(pt)
            x, y, z = coeffs(ax, deg), coeffs(ay, deg), [1] + [0] * (deg - 1)
        vals = x + y + (z if ncoord == 3 else [])
        cols.append([v * R % p for v in vals])
    return torch.from_numpy(np.stack([
        L.ints_to_words([c[k] for c in cols]) for k in range(ncoord * deg)]))


def to_host(cops, hg, words):
    return [proj_to_host(hg, pt) for pt in window_sums_to_host(cops,
                                                                words)[0]]


def point_sets(curve, group, n, seed):
    rng = np.random.default_rng(seed)
    hg, gen = host_group(curve, group)
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=2 * n)]
    P = [hg.mul(k, gen) for k in ks[:n]]
    Q = [hg.mul(k, gen) for k in ks[n:]]
    P[0] = hg.zero                   # identity + point
    Q[1] = hg.zero                   # point + identity
    P[2] = Q[2] = hg.zero            # identity + identity
    Q[3] = P[3]                      # doubling through add
    Q[4] = hg.neg(P[4])              # P + (-P)
    return hg, P, Q


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_add_dbl_vs_host(curve, group):
    n = 7
    hg, P, Q = point_sets(curve, group, n, 11)
    cops = get_curve_ops(CURVES[curve.name], group)
    deg, p = cops.deg, curve.fq.p
    Pw, Qw = to_words(P, hg, deg, p), to_words(Q, hg, deg, p)
    S = to_host(cops, hg, ec_add(cops, Pw, Qw))
    D = to_host(cops, hg, ec_dbl(cops, Pw))
    for i in range(n):
        assert hg.equal(S[i], hg.add(P[i], Q[i])), i
        assert hg.equal(D[i], hg.dbl(P[i])), i


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_mixed_add_vs_host(curve, group):
    n = 7
    hg, P, Q = point_sets(curve, group, n, 12)
    cops = get_curve_ops(CURVES[curve.name], group)
    deg, p = cops.deg, curve.fq.p
    Pw = to_words(P, hg, deg, p)
    Aw = to_words(Q, hg, deg, p, ncoord=2)
    inf = torch.tensor([hg.is_zero(q) for q in Q])
    inf[5] = True                    # a masked lane: the result is P
    M = to_host(cops, hg, ec_mixed_add(cops, Pw, Aw, inf))
    for i in range(n):
        want = P[i] if inf[i] else hg.add(P[i], Q[i])
        assert hg.equal(M[i], want), i


@pytest.mark.slow
@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_add_dbl_vs_jax_curve_ops(curve, group):
    """The same inputs through the JAX ops/ec.CurveOps (XLA:CPU)."""
    import jax.numpy as jnp
    from gpu_groth16_prover_3x_tpu.ops import ec as JEC
    from gpu_groth16_prover_3x_tpu.ops import limbs as JL
    n = 5
    hg, P, Q = point_sets(curve, group, n, 13)
    jc = JEC.get_curve_ops(curve, group)
    cops = get_curve_ops(CURVES[curve.name], group)
    deg, p = cops.deg, curve.fq.p

    assert jc.nq == 48              # the 16-bit radix of the CPU backend
    rinv = pow(R, -1, p)

    def jax_point(words):
        w = words.numpy().astype(np.int64) & 0xFFFFFFFF   # (3deg, 24, n)
        cols = np.stack([w & 0xFFFF, w >> 16], 2).reshape(3 * deg, 48, -1)
        return jc.from_arrays(tuple(jnp.asarray(c.astype(np.uint32))
                                    for c in cols), k=1)

    def jax_to_host(pt):
        arrs = [np.asarray(a) for a in jc.to_arrays(jc.normalize_k(pt))]
        out = []
        for i in range(arrs[0].shape[1]):
            v = [(JL.limbs_to_int(a[:, i:i + 1]) & ((1 << 768) - 1))
                 * rinv % p for a in arrs]
            xyz = [v[k * deg:(k + 1) * deg] for k in range(3)]
            out.append(proj_to_host(hg, tuple(
                c[0] if deg == 1 else tuple(c) for c in xyz)))
        return out

    Pw, Qw = to_words(P, hg, deg, p), to_words(Q, hg, deg, p)
    js = jax_to_host(jc.add(jax_point(Pw), jax_point(Qw)))
    jd = jax_to_host(jc.dbl(jax_point(Pw)))
    ps = to_host(cops, hg, ec_add(cops, Pw, Qw))
    pd = to_host(cops, hg, ec_dbl(cops, Pw))
    for i in range(n):
        assert hg.equal(ps[i], js[i])
        assert hg.equal(pd[i], jd[i])
