"""The port's entry points (__graft_entry_torch__.py) and its
host-to-device converters on the CPU:

  entry(device="cpu"): the example's shapes, each of the 96 window sums
      against the JAX package's host oracle (the sum of digit_j(k_i)*P_i)
      and the recombined sum against the host MSM;
  params_from_host / input_from_host: equal to the loaders of the files
      write_params / write_input write, and to the JAX package's
      converters carried across (params_from_jax / input_from_jax);
  dryrun_multichip(2, device="cpu"): two gloo ranks whose proofs equal
      the JAX package's unmasked host oracle proof of the same setup;
      rank counts the NTT split refuses raise before any process starts;
      neither entry point falls back to the CPU without a card.

Slow tier: eight ranks, and entry's window sums against the JAX
__graft_entry__.entry()'s fn on XLA:CPU (its MSM compile)."""

import random

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JCURVES
from gpu_groth16_prover_3x_tpu.host import ec as JHE
from gpu_groth16_prover_3x_tpu.host import groth16 as JHG
from gpu_groth16_prover_3x_tpu.host import msm as JHM
from gpu_groth16_prover_3x_tpu.models import tpu_prover as JTP
from gpu_groth16_prover_3x_tpu.utils import serialization as jser
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.models import setup_device as SD
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.utils import serialization as ser

import __graft_entry_torch__ as GE

N, C = 128, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def example():
    """entry(device="cpu") and its window sums (one run of fn: about
    20 s of plain group operations)."""
    fn, args = GE.entry(device="cpu")
    return fn, args, fn(*args)


def entry_host_inputs():
    """The example's scalars and points, rebuilt on the JAX package's
    host group (__graft_entry__.py:29-37)."""
    curve = JCURVES["MNT4753"]
    rng = random.Random(1234)
    hg = JHE.g1_group(curve)
    gen = JHE.g1_generator(curve)
    base = [hg.mul(3 + 5 * i, gen) for i in range(8)]
    pts = [base[i % 8] for i in range(N)]
    scalars = [rng.randrange(curve.fr.p) for _ in range(N)]
    return hg, scalars, pts


def affine_windows(ws):
    """(3, 24, 96) window sums -> 96 affine host points."""
    cops = get_curve_ops(CURVES["MNT4753"], "g1")
    hg = JHE.g1_group(JCURVES["MNT4753"])
    pts, = M.window_sums_to_host(cops, ws)
    return [hg.to_affine(M.proj_to_host(hg, pt)) for pt in pts]


def test_entry_example_shapes(example):
    fn, (keys, rows), ws = example
    assert keys.shape == (24, N) and keys.dtype == torch.int32
    assert rows.shape == (N, 48) and rows.dtype == torch.int32
    assert ws.shape == (3, 24, 768 // C) and ws.dtype == torch.int32
    assert keys.device.type == rows.device.type == ws.device.type == "cpu"
    assert callable(fn)


def test_entry_window_sums_equal_host_oracle(example):
    """Window j of fn's output, as an affine point, is the host oracle's
    sum over i of digit_j(k_i) * P_i (c = 8 unsigned digits)."""
    _, _, ws = example
    hg, scalars, pts = entry_host_inputs()
    got = affine_windows(ws)
    for j in range(768 // C):
        digits = [(k >> (C * j)) & ((1 << C) - 1) for k in scalars]
        assert got[j] == hg.to_affine(JHM.msm(hg, digits, pts)), j


def test_entry_finalized_sum_equals_host_msm(example):
    _, _, ws = example
    hg, scalars, pts = entry_host_inputs()
    cops = get_curve_ops(CURVES["MNT4753"], "g1")
    got = M.finalize_windows(cops, hg, ws, C)[0]
    assert hg.equal(got, JHM.msm(hg, scalars, pts))


@pytest.mark.parametrize("call", ["entry", "dryrun"])
def test_entry_points_need_a_card_or_cpu(call, monkeypatch):
    """No fallback: with no card and no device="cpu", both raise (the
    dryrun before its host setup and before any process starts)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(GE, "launch_local", _no_launch)
    monkeypatch.setattr(GE.host_groth16, "setup", _no_launch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GE.entry() if call == "entry" else GE.dryrun_multichip(2)


def _no_launch(*args, **kwargs):
    raise AssertionError("started work it should have refused")


@pytest.mark.parametrize("curve_name", ["MNT4753", "MNT6753"])
def test_converters_equal_file_loaders_and_jax(curve_name, tmp_path):
    """params_from_host / input_from_host equal load_params / load_input of
    the files write_params / write_input write from the same host setup
    (a point at infinity in A and in B2 included), and the JAX package's
    converters carried across by params_from_jax / input_from_jax."""
    curve = CURVES[curve_name]
    res = JHG.setup(JCURVES[curve_name], 4, random.Random(0xD15C))
    B2 = list(res.B2)
    zero2 = tuple([0] * curve.ext_degree)
    B2[1] = (zero2, zero2)
    A = list(res.A)
    A[2] = (0, 0)
    hp = ser.Groth16Params(res.d, res.m, A, res.B1, B2, res.L, res.H)
    hi = ser.Groth16Input(res.w, res.ca, res.cb, res.cc, res.r)
    params = SD.params_from_host(curve, hp)
    inputs = SD.input_from_host(curve, hi)

    ser.write_params(str(tmp_path / "p"), curve, hp.d, hp.m, hp.A, hp.B1,
                     hp.B2, hp.L, hp.H)
    ser.write_input(str(tmp_path / "i"), curve, hi.w, hi.ca, hi.cb, hi.cc,
                    hi.r)
    loaded = GP.load_params(str(tmp_path / "p"), curve)
    loaded_in = GP.load_input(str(tmp_path / "i"), curve, hp.d, hp.m)
    jcurve = JCURVES[curve_name]
    from_jax = GP.params_from_jax(JTP.params_from_host(jcurve, hp))
    from_jax_in = GP.input_from_jax(JTP.input_from_host(jcurve, hi))
    assert not params.A[2].any() and not params.B2[1].any()
    for want in (loaded, from_jax):
        assert (params.d, params.m) == (want.d, want.m)
        for f in ("A", "B1", "B2", "L", "H"):
            got, exp = getattr(params, f), getattr(want, f)
            assert got.dtype == np.int32 and got.flags.c_contiguous, f
            np.testing.assert_array_equal(got, exp, err_msg=f)
    for want in (loaded_in, from_jax_in):
        assert inputs.r == want.r
        for f in ("w_mont", "ca", "cb", "cc"):
            got, exp = getattr(inputs, f), getattr(want, f)
            assert got.dtype == np.int32 and got.flags.c_contiguous, f
            np.testing.assert_array_equal(got, exp, err_msg=f)


def jax_oracle_proof(log2_d):
    """The JAX package's unmasked host prove of the dryrun's setup
    (MNT4753, seed 0xD15C)."""
    curve = JCURVES["MNT4753"]
    res = JHG.setup(curve, log2_d, random.Random(0xD15C))
    hp = jser.Groth16Params(res.d, res.m, res.A, res.B1, res.B2, res.L,
                            res.H)
    hi = jser.Groth16Input(res.w, res.ca, res.cb, res.cc, res.r)
    return JHG.prove(curve, hp, hi)


def test_dryrun_two_cpu_ranks_equal_host_oracle():
    """Two gloo ranks on the CPU: every rank's proof equals the JAX
    package's host prove of the same setup, all windows."""
    out = GE.dryrun_multichip(2, device="cpu")
    assert (out["log2_d"], out["backend"]) == (6, "gloo")
    assert [r["rank"] for r in out["ranks"]] == [0, 1]
    want = jax_oracle_proof(6)
    for r in out["ranks"]:
        assert r["proof"] == want, r["rank"]
    # the CPU runs the plain versions: no kernel launches
    assert all(n == 0 for r in out["ranks"] for n in r["launches"].values())


class _SetupReached(Exception):
    pass


@pytest.mark.parametrize("n,log2_d", [(1, 6), (4, 6), (8, 6), (16, 8)])
def test_dryrun_accepts_rank_counts(n, log2_d, monkeypatch):
    """The rank counts the NTT split allows pass the check and set the
    JAX dryrun's domain: 2^6 up to 8 ranks, else 2^8."""
    seen = []

    def setup(curve, log2, rng):
        seen.append(log2)
        raise _SetupReached

    monkeypatch.setattr(GE, "launch_local", _no_launch)
    monkeypatch.setattr(GE.host_groth16, "setup", setup)
    with pytest.raises(_SetupReached):
        GE.dryrun_multichip(n, device="cpu")
    assert seen == [log2_d]


@pytest.mark.parametrize("n", [0, 3, 12, 32])
def test_dryrun_refuses_rank_counts_before_starting(n, monkeypatch):
    monkeypatch.setattr(GE, "launch_local", _no_launch)
    monkeypatch.setattr(GE.host_groth16, "setup", _no_launch)
    with pytest.raises(ValueError, match=r"\[1, 2, 4, 8, 16\]"):
        GE.dryrun_multichip(n, device="cpu")


def test_dryrun_mismatch_raises(monkeypatch):
    """A rank proof that differs from the oracle's fails the call."""
    monkeypatch.setattr(GE, "launch_local", lambda fn, world, args, **kw: [
        dict(rank=0, proof=None, seconds=0.0, launches={})])
    monkeypatch.setattr(GE.host_groth16, "prove",
                        lambda curve, hp, hi: ((1, 2), (3, 4), (5, 6)))
    with pytest.raises(AssertionError, match=r"ranks \[0\]"):
        GE.dryrun_multichip(1, device="cpu")


@pytest.mark.slow
def test_dryrun_eight_cpu_ranks():
    out = GE.dryrun_multichip(8, device="cpu")
    assert len(out["ranks"]) == 8 and out["log2_d"] == 6
    want = jax_oracle_proof(6)
    assert all(r["proof"] == want for r in out["ranks"])


@pytest.mark.slow
def test_entry_window_sums_equal_jax_entry(example):
    """The JAX __graft_entry__.entry()'s fn on XLA:CPU, window by window
    as affine points."""
    import __graft_entry__ as JGE
    from gpu_groth16_prover_3x_tpu.ops.ec import get_curve_ops as jget
    from gpu_groth16_prover_3x_tpu.ops.msm import (proj_to_host,
                                                   window_sums_to_host)
    _, (keys, rows), ws = example
    jfn, jargs = JGE.entry()
    curve = JCURVES["MNT4753"]
    hg = JHE.g1_group(curve)
    jpts = window_sums_to_host(jget(curve, "g1"), jfn(*jargs), curve.fq.p)
    want = [hg.to_affine(proj_to_host(hg, pt)) for pt in jpts]
    assert affine_windows(ws) == want
    # the same example: the JAX rows and scalar limbs are the port's words
    from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
    np.testing.assert_array_equal(L.jax_rows_to_words(np.asarray(jargs[1])),
                                  rows.numpy())
    np.testing.assert_array_equal(L.jax_cols_to_words(np.asarray(jargs[0])),
                                  keys.numpy())
