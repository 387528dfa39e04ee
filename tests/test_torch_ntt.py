"""Port NTT and H pipeline (ops/ntt.py over the plain mont_mul) against
the JAX package's exact host pipeline (host/groth16.compute_h and
host/fft.py); the add/sub's plain version against the port's host field
on edge words, and the H pipeline's butterfly counter."""

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import MNT4753, MNT6753, R
from gpu_groth16_prover_3x_tpu.host import groth16 as JG
from gpu_groth16_prover_3x_tpu.host.fft import get_evaluation_domain
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.host import field as HF
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops.mont_mul import mont_mul_plain
from gpu_groth16_prover_3x_tpu_torch.ops.ntt import (NttPlan, add_sub,
                                                     add_sub_plain,
                                                     compute_h, intt, ntt)
from gpu_groth16_prover_3x_tpu_torch.utils import profiling as TP


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scalars(p: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(n, 24), dtype=np.uint64)
    w[:, -1] %= p >> 736
    vals = [int.from_bytes(r.astype("<u4").tobytes(), "little") for r in w]
    vals[0], vals[-1] = 0, p - 1
    return vals


def _mont_words(vals, p):
    return torch.from_numpy(L.ints_to_words([v * R % p for v in vals]))


@pytest.mark.parametrize("curve", [MNT4753, MNT6753], ids=["mnt4", "mnt6"])
@pytest.mark.parametrize("n", [16, 32])
def test_compute_h_vs_host(curve, n):
    p = curve.fr.p
    ca, cb, cc = (_scalars(p, n, seed) for seed in (n, n + 1, n + 2))
    want = JG.compute_h(curve, n - 1, ca, cb, cc)[:n]
    plan = NttPlan(CURVES[curve.name].fr, n, "cpu")
    h_mont, h_std = compute_h(plan, *(_mont_words(v, p)
                                      for v in (ca, cb, cc)))
    rinv = pow(R, -1, p)
    assert L.words_to_ints(h_std.numpy()) == want
    assert [v * rinv % p for v in L.words_to_ints(h_mont.numpy())] == want


@pytest.mark.parametrize("n", [2, 8, 32])
def test_ntt_roundtrip_vs_host_fft(n):
    p = MNT4753.fr.p
    xs = _scalars(p, n, 40 + n)
    plan = NttPlan(CURVES["MNT4753"].fr, n, "cpu")
    y = ntt(plan, _mont_words(xs, p), plan.tw_fwd)
    rinv = pow(R, -1, p)
    dom = get_evaluation_domain(MNT4753.fr, n)
    assert [v * rinv % p for v in L.words_to_ints(y.numpy())] == \
        dom.fft(list(xs))
    back = intt(plan, y)
    assert [v * rinv % p for v in L.words_to_ints(back.numpy())] == xs


# -- the add/sub -------------------------------------------------------------

X = 0x1234_5678_9ABC_DEF0 << 600    # an ordinary value below both primes
EDGES = {
    "zeros": lambda p: (0, 0),
    "ones": lambda p: (1, 1),
    "p-1": lambda p: (p - 1, p - 1),
    "wraps": lambda p: (p - 1, 1),
    "a=b": lambda p: (X, X),
    "t=0": lambda p: (X, 0),
    "E=0": lambda p: (0, X),
    "carry-23-words": lambda p: ((1 << 736) - 1, 1),
}


@pytest.mark.parametrize("case", list(EDGES))
@pytest.mark.parametrize("p", [MNT4753.fr.p, MNT4753.fq.p],
                         ids=["P_A", "P_B"])
def test_add_sub_plain_edges_vs_host_field(p, case):
    """add_sub on CPU words (its plain version) equals the host field's
    add and sub, in both operand orders."""
    x, y = EDGES[case](p)
    a = torch.from_numpy(L.ints_to_words([x, y]))
    b = torch.from_numpy(L.ints_to_words([y, x]))
    s, d = torch.empty_like(a), torch.empty_like(a)
    add_sub(L.MontCtx(p), a, b, s, d)
    assert L.words_to_ints(s.numpy()) == [HF.e_add((x,), (y,), p)[0],
                                          HF.e_add((y,), (x,), p)[0]]
    assert L.words_to_ints(d.numpy()) == [HF.e_sub((x,), (y,), p)[0],
                                          HF.e_sub((y,), (x,), p)[0]]


def test_add_sub_plain_on_a_levels_strided_halves():
    """The NTT level's form: E the strided even half of (24, B, mp, 2, h)
    words, both results into the two halves of (24, B, 2, mp, h)."""
    p = MNT4753.fr.p
    vals = _scalars(p, 2 * 3 * 2 * 4, 7)
    v = torch.from_numpy(L.ints_to_words(vals)).reshape(24, 2, 3, 2, 4)
    E = v[:, :, :, 0]
    t = v[:, :, :, 1].contiguous()
    out = torch.zeros((24, 2, 2, 3, 4), dtype=torch.int32)
    add_sub(L.MontCtx(p), E, t, out[:, :, 0], out[:, :, 1])
    e = L.words_to_ints(E.reshape(24, -1).numpy())
    tt = L.words_to_ints(t.reshape(24, -1).numpy())
    assert L.words_to_ints(out[:, :, 0].reshape(24, -1).numpy()) == \
        [(u + w) % p for u, w in zip(e, tt)]
    assert L.words_to_ints(out[:, :, 1].reshape(24, -1).numpy()) == \
        [(u - w) % p for u, w in zip(e, tt)]


@pytest.mark.parametrize("curve", [MNT4753, MNT6753], ids=["mnt4", "mnt6"])
def test_compute_h_counts_butterflies(curve):
    """compute_h at n = 16 records 7 transforms x 4 levels in the
    counter #ntt.butterflies."""
    p = curve.fr.p
    plan = NttPlan(CURVES[curve.name].fr, 16, "cpu")
    ins = [_mont_words(_scalars(p, 16, s), p) for s in (1, 2, 3)]
    TP.clear_laps()
    compute_h(plan, *ins)
    assert TP.last_laps()["#ntt.butterflies"] == 28


@pytest.mark.parametrize("curve", [MNT4753, MNT6753], ids=["mnt4", "mnt6"])
def test_plan_with_plain_add_sub_equals_default(curve):
    """A plan given the plain add/sub (and the plain product) gives the
    default plan's words."""
    p = curve.fr.p
    fr = CURVES[curve.name].fr
    ins = [_mont_words(_scalars(p, 16, s), p) for s in (4, 5, 6)]
    want = compute_h(NttPlan(fr, 16, "cpu"), *ins)
    got = compute_h(NttPlan(fr, 16, "cpu", mul=mont_mul_plain,
                            add_sub=add_sub_plain), *ins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
