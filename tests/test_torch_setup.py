"""The port's trusted setup on the CPU (plain versions of every kernel):

  * `generate_parameters` below 2^10 (the host-oracle rule) reproduces the
    committed fixtures of tests/data/torch_port byte for byte, and its
    trapdoor equals the JAX package's at the same seed;
  * batch_exp_device (models/setup_device.py) on the windowed and the scan
    paths against host Group.mul, the window table against host
    multiples, the checkpoint cache;
  * in the slow tier, the device-path setup at log2 5 byte-identical to
    the port's and the JAX package's host oracle on both curves, and the
    G2 exponentiations of both curves.

Exact equality of canonical integers and bytes throughout.  The JAX
package's calls run with its in-place native library switched off (its
pure-Python fallbacks)."""

import json
import os
import random

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JCURVES
from gpu_groth16_prover_3x_tpu_torch.curves.constants import (CURVES,
                                                              MNT4753,
                                                              MNT6753)
from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
from gpu_groth16_prover_3x_tpu_torch.models import setup as SU
from gpu_groth16_prover_3x_tpu_torch.models import setup_device as SD
from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK
from gpu_groth16_prover_3x_tpu_torch.ops import mont_mul as MM
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.ops.inverse import to_affine_rows
from gpu_groth16_prover_3x_tpu_torch.utils import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "data", "torch_port")
CURVE_NAMES = ["MNT4753", "MNT6753"]
FILES = [f"{c}-{k}" for c in CURVE_NAMES for k in ("parameters", "input")]
# the base of the G1 exponentiations below (shared, so the window table
# is built once per worker)
G1_DLOG = 0x5EED


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def jax_native_off(monkeypatch):
    from gpu_groth16_prover_3x_tpu.utils import native as jax_native
    monkeypatch.setattr(jax_native, "_load", lambda: None)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """`generate_parameters --log2-d-4753 4 --log2-d-6753 4 --seed 42`."""
    out = tmp_path_factory.mktemp("gen4")
    assert cli.main(["generate_parameters", "--log2-d-4753", "4",
                     "--log2-d-6753", "4", "--seed", "42", "--outdir",
                     str(out), "--device", "cpu"]) == 0
    return out


@pytest.mark.parametrize("name", FILES)
def test_generate_parameters_reproduces_fixtures(name, generated):
    with open(os.path.join(FIX, name), "rb") as f:
        assert (generated / name).read_bytes() == f.read()


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_trapdoor_matches_jax(curve_name, tmp_path):
    from gpu_groth16_prover_3x_tpu.models import setup as JSU
    mine, theirs = tmp_path / "mine", tmp_path / "jax"
    for d in (mine, theirs):
        d.mkdir()
    SU.generate_parameters(CURVES[curve_name], 4, str(mine / "p"),
                           str(mine / "i"), seed=42,
                           trapdoor_path=str(mine / "t"), device="cpu")
    JSU.generate_parameters(JCURVES[curve_name], 4, str(theirs / "p"),
                            str(theirs / "i"), seed=42,
                            trapdoor_path=str(theirs / "t"))
    td = json.loads((mine / "t").read_text())
    assert td == json.loads((theirs / "t").read_text())
    assert sorted(td) == sorted(["t", "alpha", "beta", "delta", "g1_dlog",
                                 "zt", "at", "bt", "ct", "d", "m", "w", "r"])
    for name in ("p", "i", "t"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()


def base_point(curve, group, dlog=G1_DLOG):
    hg = SD.host_group(curve, group)
    gen = HE.g1_generator(curve) if group == "g1" else HE.g2_generator(curve)
    return hg, hg.mul(dlog, gen)


def edge_scalars(curve, n: int, seed: int) -> list:
    """0, 1, r - 1, r (reduces to 0) and random scalars below 2^768."""
    r = curve.fr.p
    rng = random.Random(seed)
    return [0, 1, r - 1, r] + [rng.randrange(1 << 768)
                               for _ in range(n - 4)]


def host_rows(curve, group, base, scalars) -> np.ndarray:
    hg = SD.host_group(curve, group)
    deg = 1 if group == "g1" else curve.ext_degree
    return SD.affine_rows(curve, deg, [hg.to_affine(hg.mul(s % curve.fr.p,
                                                           base))
                                       for s in scalars])


def test_batch_exp_windowed_g1_matches_host():
    hg, base = base_point(MNT4753, "g1")
    sc = edge_scalars(MNT4753, 40, 1)
    rows = SD.batch_exp_device(MNT4753, "g1", base, sc, "cpu")
    assert rows.dtype == np.int32 and rows.shape == (40, 48)
    assert np.array_equal(rows, host_rows(MNT4753, "g1", base, sc))
    assert not rows[[0, 3]].any()          # 0 and r: the all-zero row


def test_window_table_entries():
    """Sampled columns w*256 + d of the table are d * 2^(8w) * base."""
    curve = MNT4753
    hg, base = base_point(curve, "g1")
    cops = get_curve_ops(curve, "g1")
    table = SD._window_table(curve, "g1", base, torch.device("cpu"))
    assert table.shape == (3, 24, 96 * 256) and table.is_contiguous()
    cols = [(0, 0), (0, 1), (0, 255), (1, 2), (50, 77), (95, 255)]
    got = to_affine_rows(cops, table[..., [w * 256 + d for w, d in cols]]
                         .contiguous()).numpy()
    want = SD.affine_rows(curve, 1, [hg.to_affine(hg.mul(d << (8 * w), base))
                                     for w, d in cols])
    assert np.array_equal(got, want)


def test_batch_exp_scan_g1_matches_host():
    hg, base = base_point(MNT4753, "g1")
    r = MNT4753.fr.p
    sc = [0, r - 1, 0xDEADBEEF << 700]
    rows = SD.batch_exp_device(MNT4753, "g1", base, sc, "cpu")
    assert np.array_equal(rows, host_rows(MNT4753, "g1", base, sc))


def test_exp_checkpoint_cache(tmp_path, monkeypatch):
    """64 scalars in two windowed blocks of 32: three files (two blocks
    and the whole query); the second call reads the cache and launches
    nothing."""
    monkeypatch.setenv("GROTH16_SETUP_CACHE", str(tmp_path))
    monkeypatch.setenv("GROTH16_EXP_BLOCK", "32")
    hg, base = base_point(MNT4753, "g1")
    sc = edge_scalars(MNT4753, 64, 2)
    calls = []

    def spy(fn):
        def call(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return call
    for mod, name in ((GK, "ec_add"), (GK, "ec_mixed_add"), (GK, "ec_dbl"),
                      (MM, "mont_mul")):
        monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
    first = SD.batch_exp_device(MNT4753, "g1", base, sc, "cpu")
    assert calls.count("ec_add") == 2 * SD.NWIN and "ec_dbl" not in calls
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npy")]) == 3
    calls.clear()
    again = SD.batch_exp_device(MNT4753, "g1", base, sc, "cpu")
    assert calls == []
    assert np.array_equal(first, again)
    assert np.array_equal(first[:4], host_rows(MNT4753, "g1", base, sc[:4]))


def test_device_setup_refuses_a_missing_card():
    """device="cuda" without a card fails before any host work; it does
    not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        SD.setup(MNT4753, 4, random.Random(1), device="cuda")


@pytest.mark.slow
@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_device_setup_matches_host_oracles(curve_name, tmp_path):
    """log2 5 through the device path on the CPU: parameter, input and
    trapdoor files equal the port's host oracle and the JAX package's."""
    from gpu_groth16_prover_3x_tpu.models import setup as JSU
    curve = CURVES[curve_name]
    runs = {}
    for kind in ("device", "oracle", "jax"):
        d = tmp_path / kind
        d.mkdir()
        args = (str(d / "p"), str(d / "i"))
        if kind == "jax":
            JSU.generate_parameters(JCURVES[curve_name], 5, *args, seed=3,
                                    trapdoor_path=str(d / "t"))
        else:
            SU.generate_parameters(curve, 5, *args, seed=3,
                                   trapdoor_path=str(d / "t"), device="cpu",
                                   oracle=kind == "oracle")
        runs[kind] = [(d / n).read_bytes() for n in ("p", "i", "t")]
    assert runs["device"] == runs["oracle"] == runs["jax"]


@pytest.mark.slow
@pytest.mark.parametrize("windowed", [True, False], ids=["windowed", "scan"])
@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_batch_exp_g2_matches_host(curve_name, windowed, monkeypatch):
    curve = CURVES[curve_name]
    if not windowed:
        monkeypatch.setenv("GROTH16_EXP_WINDOWED", "0")
    hg, base = base_point(curve, "g2", 0xB2)
    sc = edge_scalars(curve, 33 if windowed else 4, 5)
    rows = SD.batch_exp_device(curve, "g2", base, sc, "cpu")
    assert np.array_equal(rows, host_rows(curve, "g2", base, sc))
