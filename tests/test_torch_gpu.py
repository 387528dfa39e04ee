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
from gpu_groth16_prover_3x_tpu_torch.ops.mont_mul import (MONT_MUL,
                                                          mont_mul,
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
def test_fixture_proof_on_card(curve_name, tmp_path, monkeypatch):
    card()
    monkeypatch.chdir(tmp_path)           # no table file: the Pippenger path
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


# -- the table path: inversion, table MSM, table build ------------------------

def random_projective(rng, cops, n: int) -> torch.Tensor:
    """(3*deg, 24, n) random canonical coordinates (any Z, so the affine
    normalisation is a plain field computation), every 5th lane the
    identity (Z = 0)."""
    P = torch.stack([canon(rng, cops.p, n) for _ in range(3 * cops.deg)])
    P[:, :, ::5] = M.identity_words(cops, 1, "cpu")
    return P


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_affine_normalisation_kernels_vs_plain(curve, group):
    from gpu_groth16_prover_3x_tpu_torch.ops import inverse as INV
    dev = card()
    cops = get_curve_ops(curve, group)
    P = random_projective(np.random.default_rng(5), cops, 301).to(dev)
    before = MONT_MUL.launches
    got = INV.to_affine_rows(cops, P)
    assert MONT_MUL.launches > before + 1000     # the Fermat chain ran
    want = INV.to_affine_rows(cops, P, mul=mont_mul_plain)
    assert torch.equal(got, want)
    assert not got[::5].any()                     # identity -> zero row


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_straus_window_sums_kernel_vs_plain(curve, group):
    from gpu_groth16_prover_3x_tpu_torch.ops import straus as S
    dev = card()
    rng = np.random.default_rng(6)
    cops = get_curve_ops(curve, group)
    n, d = 37, cops.deg
    table = torch.stack([canon(rng, cops.p, 31 * n)
                         for _ in range(2 * d)]).reshape(2 * d * 24, -1)
    table = table.t().contiguous()
    table[rng.random(31 * n) < 0.1, d * 24:] = 0      # infinity rows
    keys = canon(rng, curve.fr.p, n)
    keys[:, 0] = 0
    t, k = table.to(dev), keys.to(dev)
    before = GK.EC_ADD.launches
    got = S.straus_window_sums(cops, k, t)
    assert GK.EC_ADD.launches == before + 6       # ceil(log2 37) levels
    assert torch.equal(got, S.straus_window_sums_plain(cops, k, t))


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_multiples_rows_on_card_vs_cpu(curve, group):
    from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
    from gpu_groth16_prover_3x_tpu_torch.models.preprocess_device import \
        multiples_rows
    dev = card()
    rng = np.random.default_rng(7)
    hg = HE.g1_group(curve) if group == "g1" else HE.g2_group(curve)
    gen = HE.g1_generator(curve) if group == "g1" else HE.g2_generator(curve)
    p = curve.fq.p
    rows = []
    for i, k in enumerate(rng.integers(1, 1 << 40, size=9)):
        if i == 3:
            rows.append(np.zeros(2 * hg.deg * 24, np.int32))   # infinity
            continue
        x, y = hg.to_affine(hg.mul(int(k), gen))
        cs = [x, y] if hg.deg == 1 else list(x) + list(y)
        rows.append(np.concatenate([L.int_to_words(v * (1 << 768) % p)
                                    for v in cs]))
    rows = np.stack(rows)
    before = GK.EC_MIXED_ADD.launches
    got = multiples_rows(curve, group, rows, device=dev)
    assert GK.EC_MIXED_ADD.launches == before + 31
    want = multiples_rows(curve, group, rows, device="cpu")
    assert torch.equal(got.cpu(), want)


def test_table_path_fixture_proof_on_card(tmp_path, monkeypatch):
    """`gpu MNT4753 preprocess` and `compute` on the card, with the table
    file in the working directory: the committed hash."""
    card()
    from gpu_groth16_prover_3x_tpu_torch.utils import cli
    monkeypatch.chdir(tmp_path)
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port")
    with open(os.path.join(fix, "SHA256SUMS")) as f:
        want = dict(reversed(line.split()) for line in f if line.strip())
    params = os.path.join(fix, "MNT4753-parameters")
    assert cli.main(["gpu", "MNT4753", "preprocess", params]) == 0
    before = GK.EC_ADD.launches
    assert cli.main(["gpu", "MNT4753", "compute", params,
                     os.path.join(fix, "MNT4753-input"), "out"]) == 0
    assert GK.EC_ADD.launches > before
    assert hashlib.sha256((tmp_path / "out").read_bytes()).hexdigest() == \
        want["MNT4753-output"]


# -- the trusted setup on the card --------------------------------------------

@pytest.mark.parametrize("curve_name", ["MNT4753", "MNT6753"])
def test_device_setup_on_card_matches_oracle(curve_name, tmp_path):
    """log2 6 (every query windowed): parameter, input and trapdoor files
    of the device setup on the card equal the host oracle's."""
    card()
    from gpu_groth16_prover_3x_tpu_torch.models import setup as SU
    files = {}
    for oracle in (True, False):
        d = tmp_path / str(oracle)
        d.mkdir()
        before = GK.EC_ADD.launches
        SU.generate_parameters(CURVES[curve_name], 6, str(d / "p"),
                               str(d / "i"), seed=5,
                               trapdoor_path=str(d / "t"), device="cuda",
                               oracle=oracle)
        if not oracle:
            assert GK.EC_ADD.launches == before + 5 * 96
        files[oracle] = [(d / n).read_bytes() for n in ("p", "i", "t")]
    assert files[True] == files[False]


@pytest.mark.parametrize("windowed", [True, False], ids=["windowed", "scan"])
@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_batch_exp_on_card_matches_host(curve, group, windowed,
                                        monkeypatch):
    card()
    from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
    from gpu_groth16_prover_3x_tpu_torch.models import setup_device as SD
    if not windowed:
        monkeypatch.setenv("GROTH16_EXP_WINDOWED", "0")
    hg = SD.host_group(curve, group)
    gen = HE.g1_generator(curve) if group == "g1" else HE.g2_generator(curve)
    base = hg.mul(0xC0FFEE, gen)
    r = curve.fr.p
    rng = np.random.default_rng(8)
    sc = [0, 1, r - 1, r] + [int(x) << 700 | int(y) for x, y in
                             rng.integers(1, 1 << 52, size=(29, 2))]
    counter = GK.EC_ADD if windowed else GK.EC_DBL
    before = counter.launches
    rows = SD.batch_exp_device(curve, group, base, sc, "cuda")
    assert counter.launches == before + (96 if windowed else 768)
    want = SD.affine_rows(curve, hg.deg, [hg.to_affine(hg.mul(s % r, base))
                                          for s in sc])
    assert np.array_equal(rows, want)


# -- the multi-device prover: two gloo ranks on one card, nccl at world 1 -----

def multiples_rows(curve, group: str, n: int) -> np.ndarray:
    """(n, 2*deg*24) affine rows tiling 64 known multiples (3 + 7j) * G,
    every 97th row the point at infinity."""
    from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
    hg = HE.g1_group(curve) if group == "g1" else HE.g2_group(curve)
    gen = HE.g1_generator(curve) if group == "g1" else HE.g2_generator(curve)
    p = curve.fq.p
    base = []
    for j in range(64):
        x, y = hg.to_affine(hg.mul(3 + 7 * j, gen))
        cs = [x, y] if group == "g1" else list(x) + list(y)
        base.append(np.concatenate([L.int_to_words(v * (1 << 768) % p)
                                    for v in cs]))
    rows = np.stack(base)[np.arange(n) % 64]
    rows[::97, rows.shape[1] // 2:] = 0
    return np.ascontiguousarray(rows)


def test_sharded_ntt_two_ranks_on_card():
    """sharded_ntt at n = 2^12 over two gloo ranks on the one card equals
    ops/ntt.ntt on one rank, forward and inverse, word for word."""
    card()
    import torch_parallel_ranks as ranks
    from gpu_groth16_prover_3x_tpu_torch.ops.ntt import NttPlan, intt, ntt
    from gpu_groth16_prover_3x_tpu_torch.parallel import multihost
    fr = MNT4753.fr
    n = 1 << 12
    x = canon(np.random.default_rng(5), fr.p, n).numpy()
    shards = multihost.launch_local(ranks.ntt_rank, 2, ("MNT4753", x, None),
                                    backend="gloo", timeout=600)
    plan = NttPlan(fr, n, "cuda")
    xt = torch.from_numpy(x).cuda()
    for k, want in enumerate((ntt(plan, xt, plan.tw_fwd), intt(plan, xt))):
        got = np.concatenate([s[k] for s in shards], 1)
        assert np.array_equal(got, want.cpu().numpy())


@pytest.mark.parametrize("group", ["g1", "g2"], ids=["G1", "Fq2"])
def test_sharded_msm_two_ranks_on_card(group):
    """sharded_msm_window_sums of 2^12 MNT4753 points over two gloo ranks
    on the one card (one pass, two global blocks combined) finalises to
    the one-rank MSM's group element, and with block_points and
    combine=False the ranks' sums add up to it."""
    dev = card()
    import torch_parallel_ranks as ranks
    from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
    from gpu_groth16_prover_3x_tpu_torch.parallel import multihost
    n, c = 1 << 12, 8
    rows = multiples_rows(MNT4753, group, n)
    keys = canon(np.random.default_rng(6), MNT4753.fr.p, n).numpy()
    out = multihost.launch_local(
        ranks.msm_rank, 2, ("MNT4753", group, keys, rows, 128, c, True,
                            n // 2, None), backend="gloo", timeout=600)
    cops = get_curve_ops(MNT4753, group)
    hg = HE.g1_group(MNT4753) if group == "g1" else HE.g2_group(MNT4753)
    one = M.msm_window_sums(cops, torch.from_numpy(keys).to(dev),
                            torch.from_numpy(rows).to(dev), 128, c,
                            signed=True)
    want, = M.finalize_windows(cops, hg, one, c)
    assert not hg.is_zero(want)
    assert all(np.array_equal(a, b) for a, b in zip(out[0], out[1]))
    for ws in out[0][:2]:
        got, = M.finalize_windows(cops, hg, torch.from_numpy(ws), c)
        assert hg.equal(got, want)
    total = hg.zero
    for ws in out[0][2]:
        total = hg.add(total, M.finalize_windows(
            cops, hg, torch.from_numpy(ws), c)[0])
    assert hg.equal(total, want)


def test_prove_sharded_world_one_nccl_fixture():
    """prove_sharded at world 1 on nccl reproduces the committed hash of
    the MNT4753 fixture."""
    card()
    import torch_parallel_ranks as ranks
    from gpu_groth16_prover_3x_tpu_torch.parallel import multihost
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port")
    with open(os.path.join(fix, "SHA256SUMS")) as f:
        want = dict(reversed(line.split()) for line in f if line.strip())
    out, = multihost.launch_local(ranks.prove_rank, 1, ("MNT4753", None),
                                  backend="nccl", timeout=600)
    assert out["sha"] == want["MNT4753-output"]
    assert out["tally"]["msm_scan_step"] > 0


# -- host-resident rows: uploads on a copy stream --------------------------

@pytest.mark.parametrize("group", ["g1", "g2"], ids=["G1", "Fq2"])
def test_host_rows_many_blocks_equal_device_rows(group, monkeypatch):
    """2^13 MNT4753 points left in host memory, streamed in 16 blocks of
    512 (each upload on the copy stream while the card works on the
    block before), give the same window sums as the same rows on the
    card in one pass; every block went through upload_block, none
    through a copy on the compute stream."""
    dev = card()
    n, blk, c = 1 << 13, 512, 8
    cops = get_curve_ops(MNT4753, group)
    rows = multiples_rows(MNT4753, group, n)
    keys = canon(np.random.default_rng(7), MNT4753.fr.p, n).to(dev)
    streams = []
    upload = M.upload_block

    def watched(pinned, device):
        assert pinned.is_pinned()
        streams.append(torch.cuda.current_stream(device))
        return upload(pinned, device)
    monkeypatch.setattr(M, "upload_block", watched)
    got = M.msm_window_sums_streamed(cops, keys, rows, 128, c, None, 1,
                                     blk, True)
    assert len(streams) == n // blk
    assert all(s != torch.cuda.default_stream(dev) for s in streams)
    one = M.msm_window_sums(cops, keys, torch.from_numpy(rows).to(dev), 128,
                            c, signed=True)
    from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
    hg = HE.g1_group(MNT4753) if group == "g1" else HE.g2_group(MNT4753)
    a, = M.finalize_windows(cops, hg, got, c)
    b, = M.finalize_windows(cops, hg, one, c)
    assert not hg.is_zero(b) and hg.equal(a, b)


def test_msm_device_host_rows_on_card_vs_host():
    """msm_device on the card (host rows, blocks of 16) equals the host
    MSM, infinity points and a zero scalar included."""
    card()
    from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
    from gpu_groth16_prover_3x_tpu_torch.host import msm as HM
    rng = np.random.default_rng(8)
    hg, gen = HE.g1_group(MNT4753), HE.g1_generator(MNT4753)
    pts = [hg.mul(int(k), gen) for k in rng.integers(1, 1 << 40, size=50)]
    pts[3] = pts[11] = hg.zero
    sc = [int(v) for v in L.words_to_ints(canon(rng, MNT4753.fr.p, 50))]
    sc[5] = 0
    cops = get_curve_ops(MNT4753, "g1")
    got = M.msm_device(cops, hg, sc, [hg.to_affine(q) for q in pts],
                       chunk_s=8, c=8, signed=True, block_points=16)
    assert hg.equal(got, HM.msm(hg, sc, pts))


@pytest.mark.parametrize("curve_name", ["MNT4753", "MNT6753"])
def test_host_resident_fixture_proof_on_card(curve_name, tmp_path):
    """ProverSession(resident_bytes=0, block_points=48) on the card: rows
    in host memory, the committed hash."""
    card()
    from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
    from gpu_groth16_prover_3x_tpu_torch.utils import serialization as ser
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port")
    with open(os.path.join(fix, "SHA256SUMS")) as f:
        want = dict(reversed(line.split()) for line in f if line.strip())
    curve = CURVES[curve_name]
    p = GP.load_params(os.path.join(fix, f"{curve_name}-parameters"), curve)
    inp = GP.load_input(os.path.join(fix, f"{curve_name}-input"), curve,
                        p.d, p.m)
    sess = GP.ProverSession(curve, p, device="cuda", resident_bytes=0,
                            block_points=48)
    assert not sess.resident and isinstance(sess.g1_rows, np.ndarray)
    out = tmp_path / "out"
    ser.write_output(out, curve, *sess.prove(inp))
    assert hashlib.sha256(out.read_bytes()).hexdigest() == \
        want[f"{curve_name}-output"]
