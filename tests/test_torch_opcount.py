"""The port's op counters (utils/opcount.py) on the plain route: the
cases of tests/test_opcount.py, counted at call time by the kernel
wrappers instead of at trace time.  The group-op tallies are also held
against the JAX package's trace-time tally of the same batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.ops import limbs as JL
from gpu_groth16_prover_3x_tpu.ops.ec import get_curve_ops as jax_cops
from gpu_groth16_prover_3x_tpu.utils import opcount as jax_opcount
from gpu_groth16_prover_3x_tpu_torch.curves.constants import (CURVES,
                                                              MNT4753,
                                                              MNT6753)
from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.ops.mont_mul import mont_mul
from gpu_groth16_prover_3x_tpu_torch.utils import opcount


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def canon(rng, p: int, *shape) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=(24,) + shape, dtype=np.uint64)
    w[-1] %= p >> 736
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


def test_collect_scale_semantics():
    with opcount.collect() as tally:
        opcount.add("x", 3)
        with opcount.scale(10):
            opcount.add("x", 2)
            with opcount.scale(4):
                opcount.add("y")
        opcount.add("x")
    assert tally == {"x": 3 + 20 + 1, "y": 40}
    # counting is off outside collect(): no error, no tally
    assert not opcount.enabled()
    opcount.add("z", 5)
    assert "z" not in tally
    rep = opcount.report(tally)
    assert "x" in rep and "24" in rep
    # nested collect scopes do not leak into each other
    with opcount.collect() as outer:
        with opcount.collect() as inner:
            opcount.add("k", 2)
        opcount.add("k", 1)
    assert inner == {"k": 2} and outer == {"k": 1}


def test_mont_mul_counts_lanes():
    rng = np.random.default_rng(1)
    ctx = L.MontCtx(MNT4753.fq.p)
    a, b = canon(rng, ctx.p, 5), canon(rng, ctx.p, 5)
    with opcount.collect() as tally:
        mont_mul(ctx, a, b)
        mont_mul(ctx, a.reshape(24, 5, 1), b.reshape(24, 5, 1))
        with opcount.scale(3):
            mont_mul(ctx, a, b)
    assert tally == {"fp_mont_mul": 5 + 5 + 15}
    mont_mul(ctx, a, b)                      # not counted
    assert tally == {"fp_mont_mul": 25}


@pytest.mark.parametrize("curve,group", [(MNT4753, "g1"), (MNT4753, "g2"),
                                         (MNT6753, "g2")],
                         ids=["G1", "Fq2", "Fq3"])
def test_group_ops_count_lanes(curve, group):
    """ec_add, ec_dbl and ec_mixed_add count one unit a lane, as the JAX
    package counts its traced add of the same batch."""
    rng = np.random.default_rng(2)
    cops = get_curve_ops(curve, group)
    batch, d = 7, cops.deg
    P = torch.stack([canon(rng, cops.p, batch) for _ in range(3 * d)])
    xy = torch.stack([canon(rng, cops.p, batch) for _ in range(2 * d)])
    inf = torch.zeros(batch, dtype=torch.bool)
    with opcount.collect() as tally:
        GK.ec_add(cops, P, P)
        GK.ec_dbl(cops, P)
        GK.ec_mixed_add(cops, P, xy, inf)
    assert tally == {"ec_add": batch, "ec_dbl": batch,
                     "ec_mixed_add": batch}

    jc = jax_cops(curve, group)
    sds = [jax.ShapeDtypeStruct((JL.NUM_LIMBS, batch), jnp.uint32)
           for _ in range(6 * d)]

    def one_add(*arrs):
        return jc.to_arrays(jc.add(jc.from_arrays(arrs[:3 * d]),
                                   jc.from_arrays(arrs[3 * d:])))
    with jax_opcount.collect() as jtally:
        jax.make_jaxpr(one_add)(*sds)
    assert jtally["ec_add"] == tally["ec_add"]


@pytest.mark.parametrize("signed", [False, True])
def test_msm_scan_tally(signed):
    """A small MSM (16 points, chunk 4, c = 4: 192 windows): the scan runs
    every point once a window, the reduction is group adds and doubles,
    and no Montgomery product kernel runs."""
    rng = np.random.default_rng(3)
    cops = get_curve_ops(CURVES["MNT4753"], "g1")
    n, c = 16, 4
    rows = torch.stack([canon(rng, cops.p, n) for _ in range(2)])
    rows = rows.reshape(48, n).t().contiguous()
    keys = canon(rng, MNT4753.fr.p, n)
    with opcount.collect() as tally:
        M.msm_window_sums(cops, keys, rows, 4, c, signed=signed)
    assert tally["msm_scan_step"] == (768 // c) * n
    assert tally["ec_add"] > 0 and tally["ec_dbl"] > 0
    assert "fp_mont_mul" not in tally
