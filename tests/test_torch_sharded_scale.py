"""The multi-device prover's staging at the sizes of its beyond-card path,
in small: each rank's rows, keys and segment ids filled once at its block
grid (parallel/prover.py), the global block of $GROTH16_MSM_BLOCK_POINTS,
the per-rank block, the known logs of a sharded proof (utils/synthetic.py)
and prove_at_scale.py's watch over a process tree.  Ranks are gloo
processes on the CPU (parallel/multihost.launch_local)."""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu_torch.curves.constants import MNT4753
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.parallel import multihost
from gpu_groth16_prover_3x_tpu_torch.parallel import sharded as SH
from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

import prove_at_scale as PAS
import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "data", "torch_port")
TIMEOUT = 300.0
BLOCK = 48          # global points a block: 24 a rank over two ranks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def committed_sha(curve_name: str) -> str:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return dict(reversed(line.split()) for line in f
                    if line.strip())[f"{curve_name}-output"]


@functools.lru_cache(maxsize=None)
def proof_ranks(world: int, block_points, resident_bytes, env=None):
    """prove_rank on every rank of a gloo group of `world` (the MNT4753
    fixture), with $GROTH16_MSM_BLOCK_POINTS = env in the ranks."""
    saved = os.environ.get("GROTH16_MSM_BLOCK_POINTS")
    if env is None:
        os.environ.pop("GROTH16_MSM_BLOCK_POINTS", None)
    else:
        os.environ["GROTH16_MSM_BLOCK_POINTS"] = env
    try:
        return tuple(multihost.launch_local(
            ranks.prove_rank, world,
            ("MNT4753", "cpu", None, None, block_points, resident_bytes),
            backend="gloo", device="cpu", timeout=TIMEOUT, threads=1))
    finally:
        if saved is None:
            os.environ.pop("GROTH16_MSM_BLOCK_POINTS", None)
        else:
            os.environ["GROTH16_MSM_BLOCK_POINTS"] = saved


def rank_parts(p, world: int, rank: int):
    """The query rows a rank owns (parallel/prover.py's slices, worked out
    here again): G1 (A, B1, L, H) and B2."""
    m, d = p.m, p.d
    wl = -(-(m + 1) // world)
    lo, hi = min(rank * wl, m + 1), min((rank + 1) * wl, m + 1)
    nl = (d + 1) // world
    hlo = rank * nl
    l_lo, l_hi = max(lo, GP.PI1), max(hi, GP.PI1)
    g1 = [p.A[lo:hi], p.B1[lo:hi], p.L[l_lo - GP.PI1:l_hi - GP.PI1],
          p.H[hlo:min(hlo + nl, d)]]
    return g1, [p.B2[lo:hi]]


# -- each rank's rows and keys, staged once -----------------------------------

@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("resident_bytes", [0, None], ids=["host", "card"])
def test_sharded_rows_staged_once(world, resident_bytes):
    """block_points = 48: each rank holds one G1 array and one B2 array,
    each equal to pad_rows(concatenate(parts)) at the width of its block
    grid (both host numpy with resident_bytes = 0, as in a one-device
    session); every sharded MSM gets keys, rows and segment ids of that
    one width, so the streamed MSM pads nothing again; the proof keeps
    the committed sha256 on every rank.  At world 1 the rank stages what
    a one-device ProverSession stages: byte-equal G1 and B2 arrays and
    segment ids, the same chunk and window, and the same block grid."""
    p = GP.load_params(os.path.join(FIX, "MNT4753-parameters"), MNT4753)
    outs = proof_ranks(world, BLOCK, resident_bytes)
    for rank, o in enumerate(outs):
        assert o["sha"] == committed_sha("MNT4753")
        assert o["rows"] == ["host" if resident_bytes == 0 else "device"] * 2
        assert len(o["staged"]) == 2
        for parts, held, msm in zip(rank_parts(p, world, rank), o["staged"],
                                    o["msms"]):
            chunk = msm["chunk"]
            blk = SH.rank_block(BLOCK, world, chunk)
            width = M.grid_points(GP.round_up(sum(map(len, parts)), chunk),
                                  chunk, blk)
            assert held.shape[0] == width
            assert held.flags.c_contiguous
            assert np.array_equal(held, GP.pad_rows(np.concatenate(parts),
                                                    width))
            assert msm["keys"] == msm["rows"] == width
            assert msm["seg"] in (None, width)
            assert msm["block_points"] == BLOCK
            assert msm["walked"] == blk == BLOCK // world
            nblk, per = M.block_grid(width, chunk, blk)
            assert nblk * per == width        # no pad in the streamed MSM
        assert o["msms"][0]["seg"] == o["msms"][0]["keys"]
    if world == 1:
        sess = GP.ProverSession(MNT4753, p, "cpu", block_points=BLOCK,
                                resident_bytes=resident_bytes)
        o, = outs
        for held, rows in zip(o["staged"], (sess.g1_rows, sess.b2_rows)):
            assert np.array_equal(held, np.asarray(rows))
        assert np.array_equal(o["seg_ids"][0], sess.seg.numpy())
        assert o["seg_ids"][1] is None
        assert [(m["chunk"], m["c"]) for m in o["msms"]] == \
            [(sess.chunk_s, sess.c)] * 2
        assert [(m["rows"], m["walked"]) for m in o["msms"]] == \
            [(sess.n_pad, sess.block_points), (sess.n2_pad, sess.block_points)]


def test_block_points_env_is_the_argument():
    """$GROTH16_MSM_BLOCK_POINTS = 48 is the global block of block_points
    = 48 (the same scan count, MSM widths and sha on every rank), and
    = 0 is the one pass of an unforced proof of the fixture."""
    by_arg = proof_ranks(2, BLOCK, None)
    by_env = proof_ranks(2, None, None, "48")
    one_pass = proof_ranks(2, None, None, "0")
    unforced = proof_ranks(2, None, None)
    for a, e, z, u in zip(by_arg, by_env, one_pass, unforced):
        assert e["sha"] == z["sha"] == a["sha"] == committed_sha("MNT4753")
        assert e["scans"] == a["scans"] > z["scans"] == u["scans"]
        assert e["msms"] == a["msms"]
        assert z["msms"] == u["msms"]
        assert all(m["block_points"] is None and m["walked"] is None
                   for m in z["msms"])


# -- the block helpers --------------------------------------------------------

@pytest.mark.parametrize("block_points,ndev,chunk,want", [
    (None, 2, 8, None), (48, 1, 8, 48), (48, 2, 8, 24), (50, 2, 8, 24),
    (8, 4, 8, 8), (1 << 22, 2, 128, 1 << 21), (3 << 21, 4, 128, 1572864)])
def test_rank_block(block_points, ndev, chunk, want):
    """A rank's block: a multiple of the chunk, at least one chunk."""
    assert SH.rank_block(block_points, ndev, chunk) == want


@pytest.mark.parametrize("n", [8, 136, 2 ** 25 + 128, 3 * 2 ** 21 + 8])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_grid_width_is_its_own_grid(n, ndev):
    """Rows staged at grid_points(n) over the rank's block walk that same
    grid: block_grid of the staged width covers it exactly."""
    for block_points in (None, 48, GP.STREAM_BLOCK * ndev):
        blk = SH.rank_block(block_points, ndev, 8)
        width = M.grid_points(n, 8, blk)
        nblk, per = M.block_grid(width, 8, blk)
        assert width >= n and nblk * per == width
        assert M.grid_points(width, 8, blk) == width


def test_resolve_block_points_over_ranks(monkeypatch):
    """Over D ranks the default and the host-rows cap are global blocks
    of STREAM_BLOCK * D; an argument or $GROTH16_MSM_BLOCK_POINTS is
    taken as the global block (0 = one pass)."""
    monkeypatch.delenv("GROTH16_MSM_BLOCK_POINTS", raising=False)
    big, small, S = GP.STREAM_ABOVE + 1, GP.STREAM_ABOVE, GP.STREAM_BLOCK
    for D in (1, 2, 4):
        assert GP.resolve_block_points(None, big, True, D) == S * D
        assert GP.resolve_block_points(None, small, True, D) is None
        assert GP.resolve_block_points(None, small, False, D) == S * D
        assert GP.resolve_block_points(1 << 30, big, False, D) == S * D
        assert GP.resolve_block_points(48, big, True, D) == 48
    monkeypatch.setenv("GROTH16_MSM_BLOCK_POINTS", "96")
    assert GP.resolve_block_points(None, big, True, 2) == 96
    monkeypatch.setenv("GROTH16_MSM_BLOCK_POINTS", "0")
    assert GP.resolve_block_points(None, big, True, 2) is None
    assert GP.resolve_block_points(None, big, False, 2) == 2 * S


def test_one_rank_group_exchanges_nothing():
    """A one-rank group's all_to_all returns its input and all_gather a
    view of it, with 0 bytes counted, as with no group."""
    out = multihost.launch_local(ranks.one_rank_comm, 1, (), backend="gloo",
                                 device="cpu", timeout=TIMEOUT, threads=1)
    assert out == [(True, True, 0, 0)]


# -- the known logs of a sharded proof ----------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4])
def test_h_log_sums_over_domain_slices(world):
    """h_log of each rank's domain slice sums to the whole H's log, and
    known_proof takes that sum in place of the H words."""
    log2 = 6
    rng = np.random.default_rng(world)
    h = SY.rand_canon(rng, MNT4753.fr.p, (1 << log2,))
    logs = SY.query_logs(log2)
    nl = h.shape[1] // world
    parts = [SY.h_log(SY.KS, logs, h[:, r * nl:(r + 1) * nl], r * nl)
             for r in range(world)]
    whole = SY.h_log(SY.KS, logs, h, 0)
    count, shift = logs["H"]
    ints = L.words_to_ints(h)
    assert whole == SY.known_log(SY.KS, count, shift, ints)
    assert sum(parts) == whole
    w = SY.rand_canon(rng, MNT4753.fr.p, ((1 << log2) + 1,))
    assert SY.known_proof(MNT4753, SY.KS, logs, w, sum(parts), 5) == \
        SY.known_proof(MNT4753, SY.KS, logs, w, h, 5)


def test_rank_grid_of_the_sharded_runs():
    """prove_at_scale's grid per rank: G1 rows of w2-24 in 17 / 16 blocks
    of about 2^21 (rank 0 holds 2^25 + 1 rows), B2 in 5 / 4 (2^23 + 1 /
    2^23 rows); w1-24 in 32 and 9 blocks, as the one-card 2^24 proof;
    w1-25 in 64 and 17."""
    grids = {k: [PAS.rank_grid(lg, w, r) for r in range(w)]
             for k, (w, lg, _, _) in PAS.SHARDED.items()}
    assert [[g[c][1] for c in (0, 1)] for g in grids["w2-24"]] == \
        [[17, 5], [16, 4]]
    assert [grids["w2-24"][r][0][0] for r in (0, 1)] == [2 ** 25 + 1,
                                                         2 ** 25 - 1]
    assert [grids["w1-24"][0][c][1] for c in (0, 1)] == [32, 9]
    assert [grids["w1-25"][0][c][1] for c in (0, 1)] == [64, 17]


# -- prove_at_scale.py's watch over a process tree ----------------------------

GRANDCHILD = ("import sys, time; b = b'x' * (200 << 20); "
              "print('ready', flush=True); time.sleep(120)")
CHILD = ("import subprocess, sys; p = subprocess.Popen([sys.executable, "
         f"'-c', {GRANDCHILD!r}]); p.wait()")


def test_tree_rss_counts_a_grandchild():
    """A grandchild that holds 200 MB counts in its grandparent's tree sum
    (not in the child's own resident set), and kill_tree ends both."""
    child = subprocess.Popen([sys.executable, "-c", CHILD],
                             stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "ready"
        pids = PAS.tree_pids(child.pid)
        assert len(pids) == 2 and pids[0] == child.pid
        own = PAS.status_bytes(child.pid, "VmRSS")
        tree = PAS.tree_rss_bytes(child.pid)
        assert own < 100 << 20
        assert tree - own >= 200 << 20
        assert PAS.tree_rss_bytes(os.getpid()) >= tree
    finally:
        PAS.kill_tree(child.pid)
        child.wait(timeout=30)
    assert child.returncode == -9
    for pid in pids[1:]:
        for _ in range(100):
            if not os.path.exists(f"/proc/{pid}") or \
                    PAS.status_bytes(pid, "VmRSS") == 0:
                break
            time.sleep(0.1)
        assert not os.path.exists(f"/proc/{pid}") or \
            PAS.status_bytes(pid, "VmRSS") == 0
