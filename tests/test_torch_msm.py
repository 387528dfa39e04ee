"""Port Pippenger MSM (ops/msm.py over the plain versions of the scan and
group kernels) against the JAX package's exact host MSM (host/msm.py):
signed and unsigned digits, c = 4 and 8, multi-MSM segments, streamed
blocks of device-resident and of host-resident rows, msm_device, a
uniform-digit run, zero scalars and infinity rows.

Window sums are compared only through their recombined point, never
coordinate by coordinate.  The JAX msm_window_sums and msm_device legs
are slow-tier."""

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import MNT4753, MNT6753, R
from gpu_groth16_prover_3x_tpu.host import ec as JHE
from gpu_groth16_prover_3x_tpu.host import msm as JHM
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops

INF_ROWS = (3, 9)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def fixtures(curve, group, n, seed, uniform=False):
    """Scalars (standard domain) and host points; rows INF_ROWS are the
    point at infinity (y == 0 rows), a few points repeat."""
    rng = np.random.default_rng(seed)
    hg = JHE.g1_group(curve) if group == "g1" else JHE.g2_group(curve)
    gen = (JHE.g1_generator(curve) if group == "g1"
           else JHE.g2_generator(curve))
    r = curve.fr.p
    w = rng.integers(0, 1 << 32, size=(n, 24), dtype=np.uint64)
    w[:, -1] %= r >> 736
    sc = [int.from_bytes(x.astype("<u4").tobytes(), "little") for x in w]
    if uniform:
        sc = [sc[0]] * n             # every chunk one run per window
    else:
        sc[0], sc[1] = 0, r - 1
        sc[4] = sc[5] = (7 << 300) | 7
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=n)]
    pts = [hg.mul(k, gen) for k in ks]
    pts[6] = pts[7]
    for i in INF_ROWS:
        pts[i] = hg.zero
    return hg, sc, pts


def rows_of(hg, pts, deg, p):
    rows = np.zeros((len(pts), 2 * deg * 24), np.int32)
    for i, pt in enumerate(pts):
        if hg.is_zero(pt):
            continue
        x, y = hg.to_affine(pt)
        cs = [x, y] if deg == 1 else list(x) + list(y)
        rows[i] = np.concatenate([L.int_to_words(c * R % p) for c in cs])
    return torch.from_numpy(rows)


def oracle(hg, sc, pts):
    return JHM.msm(hg, sc, pts)


def port_msms(cops, hg, sc, rows, c, signed, seg=None, num_msms=1,
              chunk=8, block=None):
    keys = torch.from_numpy(L.ints_to_words(sc))
    ws = M.msm_window_sums_streamed(cops, keys, rows, chunk, c, seg,
                                    num_msms, block, signed)
    return [M.finalize_msm(hg, w, c)
            for w in M.window_sums_to_host(cops, ws, num_msms)]


@pytest.mark.parametrize("c,signed", [(4, False), (4, True), (8, False),
                                      (8, True)])
def test_msm_g1_vs_host(c, signed):
    curve = MNT4753
    hg, sc, pts = fixtures(curve, "g1", 16, 100 + c)
    cops = get_curve_ops(CURVES[curve.name], "g1")
    got = port_msms(cops, hg, sc, rows_of(hg, pts, 1, curve.fq.p), c,
                    signed)[0]
    assert hg.equal(got, oracle(hg, sc, pts))


@pytest.mark.parametrize("curve,signed", [(MNT4753, True), (MNT6753, False)],
                         ids=["mnt4-fq2-signed", "mnt6-fq3-unsigned"])
def test_msm_g2_vs_host(curve, signed):
    hg, sc, pts = fixtures(curve, "g2", 16, 7)
    cops = get_curve_ops(CURVES[curve.name], "g2")
    got = port_msms(cops, hg, sc, rows_of(hg, pts, cops.deg, curve.fq.p),
                    4, signed)[0]
    assert hg.equal(got, oracle(hg, sc, pts))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("block", [None, 12], ids=["one-pass", "streamed"])
def test_multi_msm_segments(signed, block):
    """Two MSMs fused by segment ids; the streamed form cuts 32 points
    into 2 blocks of 16 (3 blocks of at most 12 points, each rounded up
    to the chunk of 8, fit in 2)."""
    curve = MNT4753
    hg, sc, pts = fixtures(curve, "g1", 32, 21)
    cops = get_curve_ops(CURVES[curve.name], "g1")
    seg = torch.tensor([0] * 14 + [1] * 18)
    got = port_msms(cops, hg, sc, rows_of(hg, pts, 1, curve.fq.p), 4,
                    signed, seg, 2, block=block)
    assert hg.equal(got[0], oracle(hg, sc[:14], pts[:14]))
    assert hg.equal(got[1], oracle(hg, sc[14:], pts[14:]))


@pytest.mark.parametrize("signed", [False, True])
def test_uniform_digit_run(signed):
    """One scalar for every point: each window's digits form one run
    across all chunks, so every total goes through the cross-chunk
    stitch."""
    curve = MNT4753
    hg, sc, pts = fixtures(curve, "g1", 32, 5, uniform=True)
    cops = get_curve_ops(CURVES[curve.name], "g1")
    got = port_msms(cops, hg, sc, rows_of(hg, pts, 1, curve.fq.p), 4,
                    signed)[0]
    assert hg.equal(got, oracle(hg, sc, pts))


@pytest.mark.parametrize("c", [4, 8, 16])
def test_digits_recompose(c):
    """Unsigned windows and the signed borrow ripple both recompose to
    the scalar: sum_w (+-d_w) 2^(c w) == k."""
    rng = np.random.default_rng(c)
    r = MNT4753.fr.p
    w = rng.integers(0, 1 << 32, size=(40, 24), dtype=np.uint64)
    w[:, -1] %= r >> 736
    sc = [int.from_bytes(x.astype("<u4").tobytes(), "little") for x in w]
    sc[0], sc[1] = 0, r - 1
    keys = torch.from_numpy(L.ints_to_words(sc))
    dig = M.window_digits(keys, c)
    assert dig.shape == (768 // c, 40)
    mag, neg = M.signed_digits(dig, c)
    assert int(mag.max()) <= 1 << (c - 1)
    for i, k in enumerate(sc):
        assert sum(int(dig[j, i]) << (c * j)
                   for j in range(dig.shape[0])) == k
        assert sum((-1 if bool(neg[j, i]) else 1) * int(mag[j, i])
                   << (c * j) for j in range(dig.shape[0])) == k


def test_scan_plain_emits_run_totals():
    """The scan's contract on a hand-made chunk: keys 1,1,2,2,2,5 over
    points P0..P5 (P3 at infinity) emit P0+P1 at the key change and end
    with tail P2+P4 (then 5 restarts); first partial = P0+P1."""
    curve = MNT4753
    hg, sc, pts = fixtures(curve, "g1", 16, 9)
    cops = get_curve_ops(CURVES[curve.name], "g1")
    rows = rows_of(hg, pts, 1, curve.fq.p)
    idx = torch.tensor([[0], [1], [2], [3], [4], [5]], dtype=torch.int32)
    keys = torch.tensor([[1], [1], [2], [2], [2], [5]], dtype=torch.int32)
    em, valid, tail, first, chg = M.msm_scan(cops, rows, idx, keys)
    host = [M.proj_to_host(hg, q) for q in
            M.window_sums_to_host(cops, em.reshape(3, 24, -1))[0]]
    assert valid[:, 0].tolist() == [False, False, False, False, True]
    assert hg.equal(host[4], hg.add(pts[2], pts[4]))   # the run of key 2
    assert hg.equal(M.proj_to_host(hg, M.window_sums_to_host(
        cops, first)[0][0]), hg.add(pts[0], pts[1]))
    assert hg.equal(M.proj_to_host(hg, M.window_sums_to_host(
        cops, tail)[0][0]), pts[5])
    assert bool(chg[0])


GROUPS = [(MNT4753, "g1"), (MNT4753, "g2"), (MNT6753, "g1"),
          (MNT6753, "g2")]


@pytest.mark.parametrize("curve,group", GROUPS,
                         ids=["mnt4-g1", "mnt4-g2", "mnt6-g1", "mnt6-g2"])
def test_scan_plain_xyzz_edges(curve, group):
    """The scan's contract on a hand-made chunk of the benchmark's kind of
    rows, k * G with k = 3 + 7j (k 3, 10, 17, 24; row 4 at infinity):

      step  0  1   2    3    4   5    6   7
      key   1  1   2    2    2   2    5   5
      row   3  3  10  -10   17  inf  24  24

    Run 1 meets its own row (acc = next: the doubling) and totals 6 G
    (first); run 2 meets the negation of its row (acc = -next: the
    identity), then adds a row to the identity and an infinity row, and
    emits 17 G; run 3 doubles again (tail 48 G).  Two chunks, the second
    the first's key-shifted copy, so the warp tally counts one warp (both
    chunks in it) at each doubling and each conversion."""
    hg = JHE.g1_group(curve) if group == "g1" else JHE.g2_group(curve)
    gen = (JHE.g1_generator(curve) if group == "g1"
           else JHE.g2_generator(curve))
    cops = get_curve_ops(CURVES[curve.name], group)
    pts = [hg.mul(k, gen) for k in (3, 10, 17, 24)] + [hg.zero]
    rows = rows_of(hg, pts, cops.deg, curve.fq.p)
    col = [[0], [0], [1], [1], [2], [4], [3], [3]]
    key = [[1], [1], [2], [2], [2], [2], [5], [5]]
    idx = torch.tensor(col, dtype=torch.int32).repeat(1, 2)
    keys = torch.tensor(key, dtype=torch.int32) + torch.tensor([[0, 9]],
                                                               dtype=torch.int32)
    signs = torch.zeros((8, 2), dtype=torch.bool)
    signs[3] = True
    t0 = M.scan_tally("cpu")
    em, valid, tail, first, chg = M.msm_scan(cops, rows, idx, keys, signs)
    t1 = M.scan_tally("cpu")
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (2, 2)

    def host(words):
        return [M.proj_to_host(hg, q) for q in
                M.window_sums_to_host(cops, words)[0]]
    assert valid.tolist() == [[False] * 2] * 5 + [[True] * 2, [False] * 2]
    for b in range(2):
        assert hg.equal(host(em[:, :, 5])[b], pts[2])
        assert hg.equal(host(first)[b], hg.mul(6, gen))
        assert hg.equal(host(tail)[b], hg.mul(48, gen))
    assert chg.tolist() == [True, True]


def test_scan_tally_folds_into_the_record():
    """The scans' branch tallies reach the program's record at the
    readback (finalize_windows) as `#msm.scan_dbl` and
    `#msm.scan_convert`, once: a second readback adds nothing."""
    from gpu_groth16_prover_3x_tpu_torch.utils import profiling as TP
    curve = MNT4753
    hg, sc, pts = fixtures(curve, "g1", 16, 9)
    cops = get_curve_ops(CURVES[curve.name], "g1")
    rows = rows_of(hg, pts, 1, curve.fq.p)
    keys = torch.from_numpy(L.ints_to_words(sc))
    M.fold_scan_tally("cpu")            # what earlier scans left unfolded
    TP.clear_laps()
    t0 = M.scan_tally("cpu")
    with TP.span("proof", root=True):
        ws = M.msm_window_sums(cops, keys, rows, 8, 4, signed=True)
        t1 = M.scan_tally("cpu")
        got, = M.finalize_windows(cops, hg, ws, 4)
        M.finalize_windows(cops, hg, ws, 4)
    laps = TP.last_laps()
    assert laps["#msm.scan_convert"] == t1[1] - t0[1] > 0
    assert laps["#msm.scan_dbl"] == t1[0] - t0[0]
    assert hg.equal(got, oracle(hg, sc, pts))


@pytest.mark.slow
@pytest.mark.parametrize("signed", [False, True])
def test_msm_vs_jax_window_sums(signed):
    """The same MSM through the JAX package's msm_window_sums (XLA:CPU);
    the recombined points agree."""
    from gpu_groth16_prover_3x_tpu.ops.ec import get_curve_ops as jget
    from gpu_groth16_prover_3x_tpu.ops.msm import msm_device
    curve = MNT4753
    hg, sc, pts = fixtures(curve, "g1", 32, 33)
    jc = jget(curve, "g1")
    aff = [hg.to_affine(q) for q in pts]
    want = msm_device(jc, hg, sc, aff, curve.fq.p, chunk_s=8, c=4,
                      signed=signed)
    cops = get_curve_ops(CURVES[curve.name], "g1")
    got = port_msms(cops, hg, sc, rows_of(hg, pts, 1, curve.fq.p), 4,
                    signed)[0]
    assert hg.equal(got, want)


@pytest.mark.parametrize("signed", [False, True])
def test_streamed_host_rows_equal_one_pass_and_host(signed, monkeypatch):
    """The port's twin of tests/test_device_msm.py::
    test_msm_streamed_blocks: rows left in host memory (numpy),
    block_points = 24 over 64 points in chunks of 8 (three blocks of 24
    rows, the last with 8 padding rows, each scanned as a tensor of its
    own), two fused MSMs; the recombined points equal the one pass over
    the same rows as a tensor and the host MSM."""
    curve = MNT4753
    hg, sc, pts = fixtures(curve, "g1", 64, 41)
    cops = get_curve_ops(CURVES[curve.name], "g1")
    rows = rows_of(hg, pts, 1, curve.fq.p)
    seg = torch.arange(64) % 2
    scanned = []
    scan = M.msm_scan

    def counted(cops_, rows_, idx, keys, signs=None):
        scanned.append(tuple(rows_.shape))
        return scan(cops_, rows_, idx, keys, signs)
    monkeypatch.setattr(M, "msm_scan", counted)
    host = port_msms(cops, hg, sc, rows.numpy(), 4, signed, seg, 2,
                     block=24)
    assert len(scanned) % 3 == 0 and set(scanned) == {(24, 48)}
    one = port_msms(cops, hg, sc, rows, 4, signed, seg, 2)
    for i in range(2):
        want = oracle(hg, sc[i::2], pts[i::2])
        assert hg.equal(host[i], want)
        assert hg.equal(one[i], want)


@pytest.mark.parametrize("group,block", [("g1", None), ("g1", 12),
                                         ("g2", 12)])
def test_msm_device_vs_host(group, block):
    """msm_device: host scalars and affine points (the zero as (0, 0))
    to a host point, in one pass or in host-row blocks of 12."""
    curve = MNT4753
    hg, sc, pts = fixtures(curve, group, 30, 51)
    cops = get_curve_ops(CURVES[curve.name], group)
    aff = [hg.to_affine(q) for q in pts]
    got = M.msm_device(cops, hg, sc, aff, chunk_s=8, c=4, signed=True,
                       block_points=block, device="cpu")
    assert hg.equal(got, oracle(hg, sc, pts))


@pytest.mark.slow
@pytest.mark.parametrize("signed", [False, True])
def test_msm_device_vs_jax_msm_device(signed):
    """msm_device of the port and of the JAX package (XLA:CPU) on the
    same scalars and affine points give the same group element, which is
    the host MSM's."""
    from gpu_groth16_prover_3x_tpu.ops.ec import get_curve_ops as jget
    from gpu_groth16_prover_3x_tpu.ops.msm import msm_device
    curve = MNT4753
    hg, sc, pts = fixtures(curve, "g1", 32, 53)
    aff = [hg.to_affine(q) for q in pts]
    want = msm_device(jget(curve, "g1"), hg, sc, aff, curve.fq.p,
                      chunk_s=8, c=4, signed=signed)
    cops = get_curve_ops(CURVES[curve.name], "g1")
    got = M.msm_device(cops, hg, sc, aff, chunk_s=8, c=4, signed=signed,
                       block_points=16, device="cpu")
    assert hg.equal(got, want)
    assert hg.equal(got, oracle(hg, sc, pts))
