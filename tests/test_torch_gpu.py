"""The port's CUDA kernels against their plain PyTorch versions, on the
card (exact equality), plus the fixture proofs through the kernels.

Every test here needs a CUDA card: each decides so inside the test and
skips without one.  The machine with the card has no JAX, which
tests/conftest.py imports, so run them there with
    python -m pytest --noconftest tests/test_torch_gpu.py
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu_torch.curves.constants import (CURVES,
                                                              MNT4753,
                                                              MNT6753)
from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.ops.mont_mul import (mont_mul,
                                                          mont_mul_plain)

pytestmark = pytest.mark.gpu

GROUPS = [(MNT4753, "g1"), (MNT4753, "g2"), (MNT6753, "g1"),
          (MNT6753, "g2")]
IDS = ["mnt4-g1", "mnt4-g2", "mnt6-g1", "mnt6-g2"]


def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def canon(rng, p: int, *shape) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=(24,) + shape, dtype=np.uint64)
    w[-1] %= p >> 736
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


def same(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.parametrize("p", [MNT4753.fr.p, MNT4753.fq.p],
                         ids=["P_A", "P_B"])
def test_mont_mul_kernel_vs_plain(p):
    dev = card()
    rng = np.random.default_rng(1)
    ctx = L.MontCtx(p)
    a, b = canon(rng, p, 4099).to(dev), canon(rng, p, 4099).to(dev)
    a[:, 0] = 0
    a[:, 1] = b[:, 1] = torch.from_numpy(L.int_to_words(p - 1)).to(dev)
    assert torch.equal(mont_mul(ctx, a, b), mont_mul_plain(ctx, a, b))


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_group_kernels_vs_plain(curve, group):
    dev = card()
    rng = np.random.default_rng(2)
    cops = get_curve_ops(curve, group)
    n, d = 1000, cops.deg
    P = torch.stack([canon(rng, cops.p, n) for _ in range(3 * d)]).to(dev)
    Q = torch.stack([canon(rng, cops.p, n) for _ in range(3 * d)]).to(dev)
    P[:, :, ::9] = M.identity_words(cops, 1, dev)
    Q[:, :, 4::9] = P[:, :, 4::9]
    xy = torch.stack([canon(rng, cops.p, n) for _ in range(2 * d)]).to(dev)
    inf = torch.from_numpy(rng.random(n) < 0.2).to(dev)
    xy[d:, :, inf] = 0
    assert torch.equal(GK.ec_add(cops, P, Q), GK.ec_add_plain(cops, P, Q))
    assert torch.equal(GK.ec_dbl(cops, P), GK.ec_dbl_plain(cops, P))
    assert torch.equal(GK.ec_mixed_add(cops, P, xy, inf),
                       GK.ec_mixed_add_plain(cops, P, xy, inf))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_scan_kernel_vs_plain(curve, group, signed):
    dev = card()
    rng = np.random.default_rng(3)
    cops = get_curve_ops(curve, group)
    S, B, nrows = 32, 300, 500
    rows = torch.stack([canon(rng, cops.p, nrows)
                        for _ in range(2 * cops.deg)])
    rows[cops.deg:, :, torch.from_numpy(rng.random(nrows) < 0.1)] = 0
    rows = rows.reshape(-1, nrows).t().contiguous().to(dev)
    step = rng.integers(0, 3, size=(S, B)) * (rng.random((S, B)) < 0.3)
    step[:, ::7] = 0
    keys = torch.from_numpy(np.cumsum(step, 0).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, nrows, size=(S, B))
                           .astype(np.int32)).to(dev)
    signs = (torch.from_numpy(rng.random((S, B)) < 0.5).to(dev)
             if signed else None)
    assert same(M.msm_scan(cops, rows, idx, keys, signs),
                M.msm_scan_plain(cops, rows, idx, keys, signs))


def edge_values(p: int) -> list:
    """The operands that break a wrong carry resolve between lanes: 0, 1,
    p - 1, R mod p, and all-ones words on and around every border of the
    4-lane and 8-lane splits (words 3, 6, ..., 21)."""
    out = [0, 1, p - 1, p - 2, (1 << 768) % p, (1 << 736) - 1, 1 << 736,
           p - (1 << 736)]
    for w in range(3, 24, 3):
        lo, hi = 32 * (w - 1), min(32 * (w + 1), 736)
        out += [((1 << hi) - 1) ^ ((1 << lo) - 1), (1 << (32 * w)) - 1,
                1 << (32 * w)]
    assert all(0 <= v < p for v in out)
    return out


def edge_coords(rng, p: int, ncoef: int, n: int) -> torch.Tensor:
    """(ncoef, 24, n) coordinates drawn from the edge values."""
    vals = edge_values(p)
    pick = rng.integers(0, len(vals), size=(ncoef, n))
    return torch.from_numpy(np.stack(
        [L.ints_to_words([vals[i] for i in row]) for row in pick]))


@pytest.mark.parametrize("n", [1, 31, 33, 1000])
@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_group_kernels_edge_operands(curve, group, n):
    """Edge coordinates, at widths that are no multiple of the points per
    block."""
    dev = card()
    rng = np.random.default_rng(5)
    cops = get_curve_ops(curve, group)
    d = cops.deg
    P = edge_coords(rng, cops.p, 3 * d, n).to(dev)
    Q = edge_coords(rng, cops.p, 3 * d, n).to(dev)
    P[:, :, ::5] = M.identity_words(cops, 1, dev)
    Q[:, :, 3::7] = P[:, :, 3::7]
    xy = edge_coords(rng, cops.p, 2 * d, n).to(dev)
    inf = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    xy[d:, :, inf] = 0
    assert torch.equal(GK.ec_add(cops, P, Q), GK.ec_add_plain(cops, P, Q))
    assert torch.equal(GK.ec_dbl(cops, P), GK.ec_dbl_plain(cops, P))
    assert torch.equal(GK.ec_mixed_add(cops, P, xy, inf),
                       GK.ec_mixed_add_plain(cops, P, xy, inf))


@pytest.mark.parametrize("B", [1, 31, 33, 1000])
@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_scan_kernel_neighbours_diverge(curve, group, B):
    """Neighbouring chunks (groups of one warp) take different branches at
    the same step: the key changes in chunk b where it repeats in chunk
    b + 1, an infinity row sits beside a finite one, a negative digit
    beside a positive one; the rows hold edge coordinates."""
    dev = card()
    rng = np.random.default_rng(6)
    cops = get_curve_ops(curve, group)
    d, S, nrows = cops.deg, 12, 40
    rows = edge_coords(rng, cops.p, 2 * d, nrows)
    rows[d:, :, ::2] = 0                               # even rows: infinity
    rows = rows.reshape(-1, nrows).t().contiguous().to(dev)
    b = np.arange(B)[None, :]
    s = np.arange(S)[:, None]
    step = ((s + b) % 2 == 0) & (s > 0)                # change beside repeat
    step[:, 4::9] = False                              # uniform chunks
    step[:, 5::9] = s > 0                              # all-change chunks
    keys = torch.from_numpy(np.cumsum(step, 0).astype(np.int32)).to(dev)
    idx = torch.from_numpy(((s * 3 + b) % nrows).astype(np.int32)).to(dev)
    signs = torch.from_numpy((s + b) % 3 == 0).to(dev)
    for sg in (signs, None):
        assert same(M.msm_scan(cops, rows, idx, keys, sg),
                    M.msm_scan_plain(cops, rows, idx, keys, sg))


@pytest.mark.parametrize("signed", [False, True])
def test_streamed_msm_on_card_vs_cpu(signed):
    """Two MSMs fused by segments and streamed in 3 padded blocks on the
    card equal the same MSMs through the plain versions on the CPU."""
    dev = card()
    from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
    rng = np.random.default_rng(4)
    cops = get_curve_ops(MNT4753, "g1")
    hg, gen = HE.g1_group(MNT4753), HE.g1_generator(MNT4753)
    n = 40
    pts = [hg.to_affine(hg.mul(int(k), gen))
           for k in rng.integers(1, 1 << 40, size=n)]
    rows = np.zeros((n, 48), np.int32)
    for i, (x, y) in enumerate(pts):
        if i % 9 == 4:
            continue                             # infinity row
        rows[i] = np.concatenate([L.int_to_words(v * (1 << 768) % cops.p)
                                  for v in (x, y)])
    keys = canon(rng, MNT4753.fr.p, n)
    seg = torch.tensor([0] * 17 + [1] * 23)
    out = []
    for d, c in ((dev, 8), (torch.device("cpu"), 4)):
        ws = M.msm_window_sums_streamed(
            cops, keys.to(d), torch.from_numpy(rows).to(d), 8, c,
            seg.to(d), 2, 16, signed)
        out.append([M.finalize_msm(hg, w, c)
                    for w in M.window_sums_to_host(cops, ws, 2)])
    for a, b in zip(*out):
        assert hg.equal(a, b)


@pytest.mark.parametrize("curve_name", ["MNT4753", "MNT6753"])
def test_fixture_proof_on_card(curve_name, tmp_path):
    card()
    from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port")
    with open(os.path.join(fix, "SHA256SUMS")) as f:
        want = dict(reversed(line.split()) for line in f if line.strip())
    counters = (GK.EC_ADD, GK.EC_DBL, M.MSM_SCAN)
    before = [k.launches for k in counters]
    out = tmp_path / "out"
    GP.prove_files(CURVES[curve_name],
                   os.path.join(fix, f"{curve_name}-parameters"),
                   os.path.join(fix, f"{curve_name}-input"), str(out),
                   device="cuda")
    assert hashlib.sha256(out.read_bytes()).hexdigest() == \
        want[f"{curve_name}-output"]
    assert all(k.launches > b for k, b in zip(counters, before))
