"""The port's multi-device prover (parallel/) on the CPU: gloo ranks in
spawned processes (parallel/multihost.launch_local, one torch thread a
rank, every call joined with its own timeout), against the JAX package's
host oracle, ops/ntt.ntt on one rank and the committed fixture hashes.
The comparisons with the JAX package's sharded functions on the
conftest's virtual devices are slow-tier: the JAX sharded NTT alone
compiles for minutes on XLA:CPU."""

import functools
import os
import random
import time

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import MNT4753 as JMNT4753
from gpu_groth16_prover_3x_tpu.curves.constants import R
from gpu_groth16_prover_3x_tpu.host import ec as JHE
from gpu_groth16_prover_3x_tpu.host import msm as JHM
from gpu_groth16_prover_3x_tpu.host.fft import Radix2Domain
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.ops.ntt import NttPlan, intt, ntt
from gpu_groth16_prover_3x_tpu_torch.parallel import multihost
from gpu_groth16_prover_3x_tpu_torch.parallel.sharded import ShardedNttPlan

import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "data", "torch_port")
TIMEOUT = 300.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run(fn, world: int, *args, timeout: float = TIMEOUT):
    return multihost.launch_local(fn, world, args, backend="gloo",
                                  device="cpu", timeout=timeout, threads=1)


def committed_sha(curve_name: str) -> str:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return dict(reversed(line.split()) for line in f
                    if line.strip())[f"{curve_name}-output"]


def rand_ints(p: int, n: int, seed: int) -> list:
    rng = random.Random(seed)
    vals = [rng.randrange(p) for _ in range(n)]
    vals[0], vals[-1] = 0, p - 1
    return vals


# -- the NTT ----------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ntt_matches_host_and_one_rank(world):
    """n = 64 (n1 = n2 = 8): forward and inverse equal the host FFT and,
    word for word, ops/ntt.ntt on the whole vector."""
    fr = CURVES["MNT4753"].fr
    n = 64
    vals = rand_ints(fr.p, n, 0xF0 + world)
    x = L.ints_to_words([v * R % fr.p for v in vals])
    shards = run(ranks.ntt_rank, world, "MNT4753", x, "cpu")
    fwd = np.concatenate([s[0] for s in shards], 1)
    inv = np.concatenate([s[1] for s in shards], 1)
    plan = NttPlan(fr, n, "cpu")
    xt = torch.from_numpy(x)
    assert np.array_equal(fwd, ntt(plan, xt, plan.tw_fwd).numpy())
    assert np.array_equal(inv, intt(plan, xt).numpy())
    rinv = pow(R, -1, fr.p)
    dom = Radix2Domain(JMNT4753.fr, n)
    assert [v * rinv % fr.p for v in L.words_to_ints(fwd)] == \
        dom.fft(list(vals))
    assert [v * rinv % fr.p for v in L.words_to_ints(inv)] == \
        dom.ifft(list(vals))


@pytest.mark.parametrize("n,world", [(16, 8), (16, 3), (64, 16), (32, 8)])
def test_ranks_must_divide_n1_and_n2(n, world):
    with pytest.raises(ValueError, match="divisible"):
        ShardedNttPlan(CURVES["MNT4753"].fr, n, world, 0, "cpu")


def test_batched_ntt_is_rowwise():
    """ops/ntt.ntt on (24, B, n) equals B separate transforms."""
    fr = CURVES["MNT6753"].fr
    plan = NttPlan(fr, 16, "cpu")
    x = L.ints_to_words(rand_ints(fr.p, 3 * 16, 7)).reshape(24, 3, 16)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    got = ntt(plan, xt, plan.tw_inv)
    for b in range(3):
        assert torch.equal(got[:, b], ntt(plan, xt[:, b].contiguous(),
                                          plan.tw_inv))


# -- the MSM ----------------------------------------------------------------------

def msm_fixture(n: int, seed: int):
    curve = JMNT4753
    hg, gen = JHE.g1_group(curve), JHE.g1_generator(curve)
    rng = random.Random(seed)
    scalars = [rng.randrange(curve.fr.p) for _ in range(n)]
    pts = [hg.mul(rng.randrange(1, curve.fr.p), gen) for _ in range(n)]
    pts[5] = hg.zero
    rows = np.zeros((n, 48), np.int32)
    for i, pt in enumerate(pts):
        if not hg.is_zero(pt):
            x, y = hg.to_affine(pt)
            rows[i] = np.concatenate([L.int_to_words(v * R % curve.fq.p)
                                      for v in (x, y)])
    return hg, scalars, pts, L.ints_to_words(scalars), rows


@pytest.mark.parametrize("signed", [
    True, pytest.param(False, marks=pytest.mark.slow)],
    ids=["signed", "unsigned"])
def test_sharded_msm_matches_oracle(signed):
    """n = 64 points over 4 ranks, chunk 4, c = 8: one pass, and two
    global blocks of 32 combined by combine_window_sums (parallel/prover's
    streamed form in the JAX package), equal to the host MSM on every
    rank; block_points = 32 with combine=False gives each rank's sums,
    whose points add up to it.  Unsigned digits (2^8 buckets a window
    against 2^7) double the plain bucket reduction: slow-tier."""
    n, world, c = 64, 4, 8
    hg, scalars, pts, keys, rows = msm_fixture(n, 0x5EED + signed)
    want = JHM.msm(hg, scalars, pts)
    out = run(ranks.msm_rank, world, "MNT4753", "g1", keys, rows, 4, c,
              signed, 32, "cpu")
    cops = get_curve_ops(CURVES["MNT4753"], "g1")
    for sums in out[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(sums, out[0]))
    for ws in out[0][:2]:
        got, = M.finalize_windows(cops, hg, torch.from_numpy(ws), c)
        assert hg.equal(got, want)
    stacked = out[0][2]
    assert stacked.shape[0] == world
    total = hg.zero
    for ws in stacked:
        part, = M.finalize_windows(cops, hg, torch.from_numpy(ws), c)
        assert not hg.equal(part, want)
        total = hg.add(total, part)
    assert hg.equal(total, want)


# -- the prover ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sharded_proof(curve_name: str, world: int) -> tuple:
    return tuple(run(ranks.prove_rank, world, curve_name, "cpu"))


@pytest.mark.parametrize("world", [1, 2])
def test_prove_sharded_mnt4753_fixture(world):
    outs = sharded_proof("MNT4753", world)
    assert [o["sha"] for o in outs] == [committed_sha("MNT4753")] * world


def test_prove_sharded_streamed_in_global_blocks():
    """block_points = 48 streams each MSM of the MNT4753 fixture over 2
    ranks in global blocks of 24 points a rank (three scan chunks): the
    proof keeps the committed sha, with more bucket-scan calls on each
    rank than in the one pass."""
    outs = run(ranks.prove_rank, 2, "MNT4753", "cpu", None, None, 48)
    assert [o["sha"] for o in outs] == [committed_sha("MNT4753")] * 2
    one_pass = sharded_proof("MNT4753", 2)
    assert all(o["scans"] > p["scans"] for o, p in zip(outs, one_pass))


def test_prove_sharded_host_resident_rows():
    """resident_bytes = 0 and block_points = 48: each rank keeps its G1
    rows in host memory and uploads them a block at a time, in global
    blocks of 24 points a rank, while its B2 rows stay on the device (as
    in the JAX package); the proof keeps the committed sha, with more
    bucket-scan calls on each rank than in the one pass."""
    outs = run(ranks.prove_rank, 2, "MNT4753", "cpu", None, None, 48, 0)
    assert [o["sha"] for o in outs] == [committed_sha("MNT4753")] * 2
    assert [o["rows"] for o in outs] == [["host", "device"]] * 2
    one_pass = sharded_proof("MNT4753", 2)
    assert [o["rows"] for o in one_pass] == [["device", "device"]] * 2
    assert all(o["scans"] > p["scans"] for o, p in zip(outs, one_pass))


def test_scan_work_is_split_over_ranks():
    """Each of 2 ranks does half the one-rank bucket scan's point-steps,
    up to the chunk padding of its two MSM passes (G1, G2) in each of
    the 192 windows of c = 4; and half the Montgomery products of the
    NTT, up to the twiddle tables."""
    one = sharded_proof("MNT4753", 1)[0]["tally"]
    two = [o["tally"] for o in sharded_proof("MNT4753", 2)]
    chunk, nwin = 8, 192        # resolve_msm_cfg on the CPU at m = 16
    for t in two:
        assert abs(t["msm_scan_step"] - one["msm_scan_step"] / 2) <= \
            2 * chunk * nwin
        assert t["fp_mont_mul"] < 0.6 * one["fp_mont_mul"]
        assert t["all_to_all_bytes"] > 0 and t["all_gather_bytes"] > 0
    assert one["all_to_all_bytes"] == one["all_gather_bytes"] == 0


# -- process-group wiring ------------------------------------------------------------

def test_local_device_and_single_process_initialize(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.local_device("cpu") == torch.device("cpu")
    assert multihost.initialize(device="cpu") == torch.device("cpu")
    assert multihost.data_group() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.local_device()


def test_a_failing_rank_fails_the_launch():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run(ranks.failing_rank, 2, timeout=120.0)
    assert time.monotonic() - t0 < 100.0


# -- slow: more ranks, the other curve, the JAX package's sharded functions ----------

@pytest.mark.slow
@pytest.mark.parametrize("world", [2, 4])
def test_prove_sharded_mnt6753_fixture(world):
    outs = sharded_proof("MNT6753", world)
    assert [o["sha"] for o in outs] == [committed_sha("MNT6753")] * world


@pytest.mark.slow
def test_prove_sharded_mnt4753_four_ranks():
    outs = sharded_proof("MNT4753", 4)
    assert [o["sha"] for o in outs] == [committed_sha("MNT4753")] * 4


def jax_mesh(world: int):
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < world:
        pytest.skip(f"needs {world} virtual devices")
    return Mesh(np.array(devs[:world]), ("data",))


@pytest.mark.slow
def test_sharded_ntt_matches_jax_sharded_ntt():
    import jax.numpy as jnp
    from gpu_groth16_prover_3x_tpu.ops.ntt import get_plan
    from gpu_groth16_prover_3x_tpu.parallel.sharded import (get_sharded_plan,
                                                            sharded_ntt)
    from gpu_groth16_prover_3x_tpu.utils.serialization import (
        ints_to_u16x48, u16x48_to_ints)
    world, n = 4, 64
    fr = JMNT4753.fr
    vals = rand_ints(fr.p, n, 0xA1)
    mesh = jax_mesh(world)
    splan = get_sharded_plan(get_plan(fr, n), world)
    xj = jnp.asarray(ints_to_u16x48(vals, fr.p).T.astype(np.uint32))
    x = L.ints_to_words([v * R % fr.p for v in vals])
    shards = run(ranks.ntt_rank, world, "MNT4753", x, "cpu")
    rinv = pow(R, -1, fr.p)
    for k, inverse in enumerate((False, True)):
        want = u16x48_to_ints(np.asarray(
            sharded_ntt(splan, mesh, xj, inverse=inverse)).T, fr.p)
        got = L.words_to_ints(np.concatenate([s[k] for s in shards], 1))
        assert [v * rinv % fr.p for v in got] == [w % fr.p for w in want]


@pytest.mark.slow
def test_sharded_msm_matches_jax_sharded_msm():
    import jax.numpy as jnp
    from gpu_groth16_prover_3x_tpu.ops.ec import get_curve_ops as jax_cops
    from gpu_groth16_prover_3x_tpu.ops.msm import (affine_points_to_rows,
                                                   finalize_msm,
                                                   scalars_to_limbs,
                                                   window_sums_to_host)
    from gpu_groth16_prover_3x_tpu.parallel.sharded import \
        sharded_msm_window_sums
    n, world, c = 64, 4, 8
    hg, scalars, pts, keys, rows = msm_fixture(n, 0xBEEF)
    jc = jax_cops(JMNT4753, "g1")
    ws = sharded_msm_window_sums(
        jc, jax_mesh(world), jnp.asarray(scalars_to_limbs(scalars)),
        jnp.asarray(affine_points_to_rows(
            [hg.to_affine(p) for p in pts], JMNT4753.fq.p, 1)),
        chunk_s=4, c=c)
    want = finalize_msm(hg, window_sums_to_host(jc, ws, JMNT4753.fq.p))
    out = run(ranks.msm_rank, world, "MNT4753", "g1", keys, rows, 4, c,
              False, 32, "cpu")
    cops = get_curve_ops(CURVES["MNT4753"], "g1")
    got, = M.finalize_windows(cops, hg, torch.from_numpy(out[0][0]), c)
    assert hg.equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("curve_name", ["MNT4753", "MNT6753"])
def test_prove_sharded_matches_jax_prove_sharded(curve_name):
    """log2 d = 5: the JAX prove_sharded on 4 virtual devices and the
    port's on 2 gloo ranks, weights carried by params_from_jax /
    input_from_jax (the counterpart of test_multichip.py:57-97)."""
    import jax
    from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JC
    from gpu_groth16_prover_3x_tpu.host import groth16 as JG
    from gpu_groth16_prover_3x_tpu.models.tpu_prover import (
        input_from_host, params_from_host)
    from gpu_groth16_prover_3x_tpu.parallel.prover import prove_sharded
    from gpu_groth16_prover_3x_tpu.utils.serialization import (
        Groth16Input, Groth16Params)
    from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
    curve = JC[curve_name]
    res = JG.setup(curve, 5, random.Random(0xD15D))
    hp = Groth16Params(res.d, res.m, res.A, res.B1, res.B2, res.L, res.H)
    hi = Groth16Input(res.w, res.ca, res.cb, res.cc, res.r)
    jp, ji = params_from_host(curve, hp), input_from_host(curve, hi)
    prev = jax.config.jax_use_shardy_partitioner
    jax.config.update("jax_use_shardy_partitioner", False)
    try:
        want = prove_sharded(curve, jp, ji, jax_mesh(4), chunk_s=4, c=8,
                             hostcall=True)
    finally:
        jax.config.update("jax_use_shardy_partitioner", prev)
    outs = run(ranks.prove_rank, 2, curve_name, "cpu", GP.params_from_jax(jp),
               GP.input_from_jax(ji), timeout=900.0)
    assert [o["proof"] for o in outs] == [tuple(want)] * 2
