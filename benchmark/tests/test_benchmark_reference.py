"""The reference's proof equals the port's on the CPU route, at 2^4 to
2^6, for both curves, by Pippenger and by the Straus tables; its sums in
column blocks equal its sums in one block."""

import numpy as np
import pytest
import torch

from groth16_ref import algebra, curves, keys, proof

from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.models.preprocess_device import \
    multiples_rows
from gpu_groth16_prover_3x_tpu_torch.utils.profiling import \
    set_profiling_enabled


def _params(name, log2):
    base = keys.base_rows(curves.CURVES[name])
    q = {k: keys.query_rows(k, log2, base) for k in keys.QUERIES}
    sz = keys.sizes(log2)
    return GP.DeviceParams(sz["d"], sz["m"], q["A"], q["B1"], q["B2"],
                           q["L"], q["H"])


@pytest.mark.parametrize("name,log2,tables", [
    ("MNT4753", 4, False), ("MNT6753", 5, False), ("MNT4753", 6, False),
    ("MNT4753", 4, True), ("MNT6753", 4, True)])
def test_reference_equals_port(name, log2, tables):
    set_profiling_enabled(False)
    torch.set_num_threads(2)
    params = _params(name, log2)
    tab = None
    if tables:
        c = CURVES[name]
        tab = tuple(multiples_rows(c, g, rows, device="cpu")
                    for rows, g in ((params.B1, "g1"), (params.B2, "g2"),
                                    (params.L, "g1")))
    sess = GP.ProverSession(CURVES[name], params, "cpu", tables=tab)
    rc = curves.CURVES[name]
    ref = proof.Reference(rc, log2, "cpu")
    v = keys.InputStream(rc, log2, 7 + log2, "cpu").next()
    got = sess.prove(GP.DeviceInput(v[0].T, v[1].T, v[2].T, v[3].T, v[4]))
    assert algebra.proof_bytes(rc, *got) == ref.expect(v)


def test_h_log_equals_coefficient_sum():
    """The reference's H log is S_H * sum_(i<d) h_i t^i of the port's own
    H coefficients (ops/ntt.compute_h on the CPU)."""
    from gpu_groth16_prover_3x_tpu_torch.ops.ntt import NttPlan, compute_h
    name, log2 = "MNT6753", 5
    rc = curves.CURVES[name]
    p, n = rc.fr.p, 1 << log2
    _, ca, cb, cc, _ = keys.InputStream(rc, log2, 3, "cpu").next()
    dev = [torch.from_numpy(np.ascontiguousarray(x)) for x in (ca, cb, cc)]
    h = compute_h(NttPlan(CURVES[name].fr, n, "cpu"), *dev)[1].numpy()
    hs = [proof.word_int(h, i) for i in range(n)]
    t = keys.h_root(rc)
    want = keys.S_H * sum(hs[i] * pow(t, i, p) for i in range(n - 1)) % p
    ref = proof.Reference(rc, log2, "cpu")
    assert ref.h_log(ca, cb, cc) == want
    ctl = proof.Reference(rc, log2, "cpu", with_top_h=True)
    assert ctl.h_log(ca, cb, cc) != want


def test_exact_dot_and_product():
    from groth16_ref import limbs
    rng = np.random.default_rng(5)
    xs = rng.integers(0, 1 << 32, size=(24, 300), dtype=np.uint32)
    ys = rng.integers(0, 1 << 32, size=(24, 300), dtype=np.uint32)
    xi = [proof.word_int(xs.view(np.int32), i) for i in range(300)]
    yi = [proof.word_int(ys.view(np.int32), i) for i in range(300)]
    x16 = limbs.words_to_u16(xs.view(np.int32), "cpu")
    y16 = limbs.words_to_u16(ys.view(np.int32), "cpu")
    assert limbs.dot(x16, y16) == sum(a * b for a, b in zip(xi, yi))
    prod = limbs.product_u16(x16, y16)
    assert limbs.dot(prod, y16) == sum(a * b * b
                                       for a, b in zip(xi, yi))


def test_batch_inverse_and_powers():
    from groth16_ref import limbs
    p = curves.CURVES["MNT4753"].fr.p
    F = limbs.Field(p, "cpu")
    R = 1 << 768
    om = limbs.power_table(F, 5 * R % p, 16)
    vals = [limbs.limbs_to_int(om[:, i]) for i in range(16)]
    assert vals == [pow(5, i, p) * R % p for i in range(16)]
    inv = limbs.batch_inverse(F, om)
    for i in range(16):
        x = limbs.limbs_to_int(inv[:, i]) * pow(R, -1, p) % p
        assert x * pow(5, i, p) % p == 1


@pytest.mark.parametrize("seed", [2 ** 33 + 5, 17])
@pytest.mark.parametrize("with_top_h", [False, True])
@pytest.mark.parametrize("name", ["MNT4753", "MNT6753"])
def test_blocked_sums_equal_one_block(monkeypatch, name, with_top_h, seed):
    """The H sums in blocks of 2^3 columns at 2^8 (32 blocks, each with
    its own power table from omega^lo and its own inverse) give the logs
    and the proof bytes of one block over all 2^8 columns."""
    torch.set_num_threads(2)
    rc, log2 = curves.CURVES[name], 8
    v = keys.InputStream(rc, log2, seed, "cpu").next()
    got = {}
    for blk in (1 << 3, 1 << log2):
        monkeypatch.setattr(proof, "BLOCK_COLS", blk)
        ref = proof.Reference(rc, log2, "cpu", with_top_h=with_top_h)
        assert ref.block == blk
        got[blk] = (ref.logs(v), ref.expect(v))
    assert got[1 << 3] == got[1 << log2]
