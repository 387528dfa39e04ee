"""Port NTT and H pipeline (ops/ntt.py over the plain mont_mul) against
the JAX package's exact host pipeline (host/groth16.compute_h and
host/fft.py)."""

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import MNT4753, MNT6753, R
from gpu_groth16_prover_3x_tpu.host import groth16 as JG
from gpu_groth16_prover_3x_tpu.host.fft import get_evaluation_domain
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops.ntt import (NttPlan, compute_h, intt,
                                                     ntt)


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
