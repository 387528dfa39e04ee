"""The port's main path at the sizes of its beyond-card path, in small:
the H pipeline's plain add/sub in column blocks, the query rows staged
once at the streamed MSM's block grid, and the in-memory synthetic keys
with their vectorised known logs (utils/synthetic.py)."""

import hashlib
import os

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.ops import ntt as JN
from gpu_groth16_prover_3x_tpu.utils.serialization import u16x48_to_ints
from gpu_groth16_prover_3x_tpu_torch.curves.constants import (CURVES,
                                                              MNT4753,
                                                              MNT6753)
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops import ntt as N
from gpu_groth16_prover_3x_tpu_torch.utils import serialization as ser
from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def h_inputs(curve, log2: int, seed: int):
    rng = np.random.default_rng(seed)
    return [SY.rand_canon(rng, curve.fr.p, (1 << log2,)) for _ in range(3)]


# -- the H pipeline in column blocks ---------------------------------------------

@pytest.mark.parametrize("curve", [MNT4753, MNT6753], ids=["mnt4", "mnt6"])
@pytest.mark.parametrize("log2", [6, 8])
def test_compute_h_in_blocks_of_16_lanes(curve, log2, monkeypatch):
    """compute_h with COL_BLOCK = 16 lanes (every level and the a*b - c
    subtraction in many blocks) equals the one-block result word for
    word."""
    ins = [torch.from_numpy(a) for a in h_inputs(curve, log2, log2)]
    plan = N.NttPlan(curve.fr, 1 << log2, "cpu")
    assert N.COL_BLOCK >= 1 << log2
    want = N.compute_h(plan, *ins)
    monkeypatch.setattr(N, "COL_BLOCK", 16)
    got = N.compute_h(plan, *ins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("width", [3, 16, 1 << 21])
def test_batched_ntt_in_blocks(width, monkeypatch):
    """The (24, B, n) transforms of the four-step passes: any block width
    gives each row's own transform."""
    curve = MNT4753
    rng = np.random.default_rng(9)
    x = torch.from_numpy(SY.rand_canon(rng, curve.fr.p, (4, 32)))
    plan = N.NttPlan(curve.fr, 32, "cpu")
    monkeypatch.setattr(N, "COL_BLOCK", width)
    got = N.ntt(plan, x, plan.tw_fwd)
    monkeypatch.setattr(N, "COL_BLOCK", 1 << 21)
    for b in range(4):
        assert torch.equal(got[:, b], N.ntt(plan, x[:, b].contiguous(),
                                            plan.tw_fwd))


def jax_cols(words: np.ndarray) -> np.ndarray:
    """(24, n) int32 words -> the JAX package's (48, n) 16-bit limbs."""
    w = words.view(np.uint32)
    return np.stack([w & 0xFFFF, w >> 16], 1).reshape(48, -1)


@pytest.mark.parametrize("curve", [MNT4753, MNT6753], ids=["mnt4", "mnt6"])
def test_blocked_compute_h_equals_jax_device(curve, monkeypatch):
    """At 2^6, compute_h in blocks of 16 lanes equals the JAX package's
    compute_h_device on XLA:CPU (as tests/test_device_ntt.py runs it) on
    the same seeded Montgomery words: the same values, exactly."""
    import jax.numpy as jnp
    from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JC
    ins = h_inputs(curve, 6, 60)
    monkeypatch.setattr(N, "COL_BLOCK", 16)
    h_mont, h_std = N.compute_h(N.NttPlan(curve.fr, 64, "cpu"),
                                *(torch.from_numpy(a) for a in ins))
    jplan = JN.get_plan(JC[curve.name].fr, 64)
    jm, js = JN.compute_h_device(jplan, *(jnp.asarray(jax_cols(a))
                                          for a in ins))
    p = curve.fr.p
    assert [v % p for v in u16x48_to_ints(np.asarray(jm).T, p)] == \
        [v % p for v in u16x48_to_ints(
            jax_cols(h_mont.numpy()).T, p)]
    assert [v % p for v in u16x48_to_ints(np.asarray(js).T, p,
                                          from_montgomery=False)] == \
        L.words_to_ints(h_std.numpy())


# -- the streamed MSM's block grid ----------------------------------------------

@pytest.mark.parametrize("n,chunk,block", [
    ((1 << 26) + 128, 128, 1 << 21), ((1 << 25) + 128, 128, 1 << 21),
    (1 << 27, 128, 1 << 21), (1000, 8, 48), (2432, 8, 48), (640, 128, None),
    (136, 8, 1 << 21)])
def test_block_grid_of_its_own_width_is_the_same(n, chunk, block):
    """Rows padded to grid_points are cut into the same blocks again, so
    msm_window_sums_streamed pads neither them nor their keys."""
    nblk, B = M.block_grid(n, chunk, block)
    assert B % chunk == 0 and nblk * B >= n > (nblk - 1) * B
    if block is not None:
        assert nblk == -(-n // max(chunk, block))
    assert M.block_grid(nblk * B, chunk, block) == (nblk, B)
    assert M.grid_points(n, chunk, block) == nblk * B


# -- in-memory synthetic keys ----------------------------------------------------

@pytest.mark.parametrize("curve,log2", [(MNT4753, 6), (MNT6753, 5)],
                         ids=["mnt4", "mnt6"])
def test_params_arrays_equal_the_file(curve, log2, tmp_path):
    path = str(tmp_path / "params")
    SY.write_params(curve, log2, path)
    want = GP.load_params(path, curve)
    got = SY.params_arrays(curve, log2)
    assert (got.d, got.m) == (want.d, want.m) == ((1 << log2) - 1, 1 << log2)
    for name in ("A", "B1", "B2", "L", "H"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("log2", [6, 7])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_tiled_log_equals_known_log(log2, shift, monkeypatch):
    """Every query's count at 2^log2 (m + 1, m - 1, d), from column 0 and
    from column 2 (L's witness slice), in parts of 48 columns (not a
    multiple of the 64 classes) and in one part."""
    rng = np.random.default_rng(100 + log2)
    words = SY.rand_canon(rng, MNT4753.fr.p, ((1 << log2) + 1,))
    ints = L.words_to_ints(words)
    for count, _ in SY.query_logs(log2).values():
        for lo in (0, 2):
            n = min(count, words.shape[1] - lo)
            want = SY.known_log(SY.KS, n, shift, ints[lo:])
            assert SY.tiled_log(SY.KS, words[:, lo:lo + n], shift) == want
            monkeypatch.setattr(SY, "TILE_COLUMNS", 48)
            assert SY.tiled_log(SY.KS, words[:, lo:lo + n], shift) == want
            monkeypatch.setattr(SY, "TILE_COLUMNS", 1 << 20)


def test_session_on_params_arrays_equals_the_file_path(tmp_path,
                                                       monkeypatch):
    """ProverSession(resident_bytes=0, block_points=48) on params_arrays
    and input_arrays gives the proof prove_files writes from the same
    keys and input, equal to expected_proof's known logs."""
    monkeypatch.chdir(tmp_path)            # no table file can be taken
    monkeypatch.delenv("GROTH16_PREPROCESSED_PATH", raising=False)
    curve, log2 = MNT4753, 4
    params, inp, ks, logs, values = SY.write_synthetic(
        curve, log2, str(tmp_path), np.random.default_rng(44))
    out = str(tmp_path / "out")
    GP.prove_files(curve, params, inp, out, device="cpu")
    sess = GP.ProverSession(curve, SY.params_arrays(curve, log2), "cpu",
                            resident_bytes=0, block_points=48)
    assert not sess.resident and sess.block_points == 48
    got = sess.prove(SY.input_arrays(values))
    assert got == SY.read_proof(out, curve)
    assert got == SY.expected_proof(curve, log2, ks, logs, values, "cpu")


# -- host rows: one padded array per group ----------------------------------------

def committed_sha() -> dict:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return dict(reversed(line.split()) for line in f if line.strip())


@pytest.mark.parametrize("curve_name", ["MNT4753", "MNT6753"])
@pytest.mark.parametrize("resident_bytes", [0, None], ids=["host", "card"])
def test_session_rows_staged_once(curve_name, resident_bytes, tmp_path,
                                  monkeypatch):
    """The session holds one G1 array and one B2 array, each equal to
    pad_rows(concatenate(parts)) at the block grid's width: host numpy
    with resident_bytes=0, else a tensor on the device.  Every MSM gets
    rows and keys at that width, so none is padded again, and the proof
    keeps its committed sha256."""
    curve = CURVES[curve_name]
    p = GP.load_params(os.path.join(FIX, f"{curve_name}-parameters"), curve)
    inp = GP.load_input(os.path.join(FIX, f"{curve_name}-input"), curve,
                        p.d, p.m)
    sess = GP.ProverSession(curve, p, "cpu", resident_bytes=resident_bytes,
                            block_points=48)
    assert sess.resident == (resident_bytes is None)
    parts = {"g1": [p.A[:p.m + 1], p.B1[:p.m + 1], p.L, p.H[:p.d]],
             "b2": [p.B2[:p.m + 1]]}
    for name, rows in (("g1", sess.g1_rows), ("b2", sess.b2_rows)):
        cat = np.concatenate(parts[name])
        n_pad = M.grid_points(GP.round_up(len(cat), sess.chunk_s),
                              sess.chunk_s, 48)
        assert rows.shape[0] == n_pad
        host = isinstance(rows, np.ndarray)
        assert host == (resident_bytes == 0)
        held = rows if host else rows.numpy()
        assert held.flags.c_contiguous
        assert np.array_equal(held, GP.pad_rows(cat, n_pad))
    widths = []
    streamed = GP.msm_window_sums_streamed

    def keep(cops, keys, rows, *args):
        widths.append((keys.shape[1], rows.shape[0]))
        return streamed(cops, keys, rows, *args)
    monkeypatch.setattr(GP, "msm_window_sums_streamed", keep)
    out = tmp_path / "out"
    ser.write_output(out, curve, *sess.prove(inp))
    assert widths == [(sess.n_pad, sess.n_pad), (sess.n2_pad, sess.n2_pad)]
    assert hashlib.sha256(out.read_bytes()).hexdigest() == \
        committed_sha()[f"{curve_name}-output"]
