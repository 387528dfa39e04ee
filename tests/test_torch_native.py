"""The port's native host library (utils/native.py + csrc/limb_host.cpp)
on the CPU: where it is built, that two processes building it at once
both load it, each function against its pure-Python fallback, and the
native Horner epilogue of the device MSM against finalize_msm.  Exact
equality of canonical integers throughout."""

import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu_torch.curves.constants import (MNT4753,
                                                              MNT6753, R)
from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
from gpu_groth16_prover_3x_tpu_torch.host import msm as HM
from gpu_groth16_prover_3x_tpu_torch.host.fft import Radix2Domain
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gpu_groth16_prover_3x_tpu_torch")
GROUPS = [(MNT4753, "g1"), (MNT4753, "g2"), (MNT6753, "g1"),
          (MNT6753, "g2")]
IDS = ["mnt4-g1", "mnt4-g2", "mnt6-g1", "mnt6-g2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def no_native(monkeypatch):
    """The pure-Python fallbacks: the library reads as absent."""
    monkeypatch.setattr(native, "_load", lambda: None)


def host_group(curve, group):
    return HE.g1_group(curve) if group == "g1" else HE.g2_group(curve)


def generator(curve, group):
    return HE.g1_generator(curve) if group == "g1" else \
        HE.g2_generator(curve)


def u64_rows(vals) -> np.ndarray:
    return native._ints_to_limbs(vals)


def test_library_builds_into_the_package_build_dir():
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(PKG, "_build")
    assert os.path.isfile(path)
    # nothing is built beside the source
    assert not [f for f in os.listdir(os.path.join(PKG, "csrc"))
                if f.endswith(".so")]


def test_two_processes_building_at_once_both_load(tmp_path):
    """A fresh copy of the module and its source, built by two processes
    started together: each loads a whole library, one file is left."""
    for sub, name in (("utils", "native.py"), ("csrc", "limb_host.cpp")):
        os.makedirs(tmp_path / sub)
        shutil.copy(os.path.join(PKG, sub, name), tmp_path / sub / name)
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('nat', sys.argv[1])\n"
        "nat = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(nat)\n"
        "import numpy as np\n"
        "p = int(sys.argv[2])\n"
        "a = nat._ints_to_limbs([12345])\n"
        "assert nat.available()\n"
        "assert nat._limbs_to_ints(nat.mont_decode(nat.mont_encode(a, p), "
        "p)) == [12345]\n"
        "print('ok')\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path / "utils" / "native.py"),
         str(MNT4753.fq.p)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    assert [f for f in os.listdir(tmp_path / "_build")] == \
        [os.path.basename(native.library_path())]


@pytest.mark.parametrize("p", [MNT4753.fq.p, MNT4753.fr.p],
                         ids=["P_B", "P_A"])
def test_mont_mul_encode_decode_equal_fallback(p, monkeypatch):
    rng = random.Random(p % 1000)
    vals = [0, 1, p - 1] + [rng.randrange(p) for _ in range(29)]
    a, b = u64_rows(vals), u64_rows(vals[::-1])
    got = (native.mont_mul_batch(a, b, p), native.mont_encode(a, p),
           native.mont_decode(a, p), native.mont_mul_batch(a, b[:1], p))
    monkeypatch.setattr(native, "_load", lambda: None)
    want = (native.mont_mul_batch(a, b, p), native.mont_encode(a, p),
            native.mont_decode(a, p), native.mont_mul_batch(a, b[:1], p))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    rinv = pow(R, -1, p)
    assert native._limbs_to_ints(got[0]) == [
        x * y * rinv % p for x, y in zip(vals, vals[::-1])]


def test_batch_affine_equals_fallback(monkeypatch):
    p = MNT4753.fq.p
    rng = random.Random(3)
    zs = [0] + [rng.randrange(1, p) for _ in range(15)]
    xs = [rng.randrange(p) for _ in zs]
    ys = [rng.randrange(p) for _ in zs]
    args = [native.mont_encode(u64_rows(v), p) for v in (xs, ys, zs)]
    got = native.batch_affine(*args, p)
    monkeypatch.setattr(native, "_load", lambda: None)
    want = native.batch_affine(*args, p)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    x0 = native._limbs_to_ints(native.mont_decode(got[0], p))
    assert x0[0] == 0 and x0[1] == xs[1] * pow(zs[1], -1, p) % p


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_msm_native_equals_python(curve, group, monkeypatch):
    """host/msm.msm through g16_msm (n >= 64) and through the Python
    buckets; scalars of 200 bits keep the Python side short."""
    hg = host_group(curve, group)
    rng = random.Random(7)
    gen = generator(curve, group)
    pts = [hg.mul(rng.randrange(1, 1 << 40), gen) for _ in range(64)]
    pts[5] = hg.zero
    sc = [rng.randrange(1 << 200) for _ in pts]
    sc[0] = 0
    got = HM.msm(hg, sc, pts)
    monkeypatch.setattr(native, "_load", lambda: None)
    want = HM.msm(hg, sc, pts)
    assert hg.to_affine(got) == hg.to_affine(want)


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_fixed_base_native_equals_python(curve, group, monkeypatch):
    hg = host_group(curve, group)
    rng = random.Random(8)
    base = hg.mul(rng.randrange(2, 1 << 40), generator(curve, group))
    r = curve.fr.p
    sc = [0, 1, r - 1, rng.randrange(r)]
    got = HM.fixed_base_msm(hg, base, sc, 3)
    monkeypatch.setattr(native, "_load", lambda: None)
    want = HM.fixed_base_msm(hg, base, sc, 3)
    assert [hg.to_affine(x) for x in got] == [hg.to_affine(x) for x in want]
    assert hg.to_affine(got[2]) == hg.to_affine(hg.mul(r - 1, base))


@pytest.mark.parametrize("curve", [MNT4753, MNT6753],
                         ids=["MNT4753", "MNT6753"])
def test_fft_native_equals_python(curve, monkeypatch):
    dom = Radix2Domain(curve.fr, 64)
    rng = random.Random(9)
    a = [rng.randrange(curve.fr.p) for _ in range(64)]
    got = (dom.fft(list(a)), dom.ifft(list(a)), dom.coset_fft(list(a)))
    monkeypatch.setattr(native, "_load", lambda: None)
    want = (dom.fft(list(a)), dom.ifft(list(a)), dom.coset_fft(list(a)))
    assert got == want


def random_window_sums(curve, group, nwin: int, num: int, seed: int):
    """(3*deg, 24, nwin*num) projective points k*G scaled by a random Z,
    the top window of MSM 0 and one more window the identity."""
    cops = get_curve_ops(curve, group)
    deg, p, alpha = cops.deg, curve.fq.p, curve.non_residue
    hg = host_group(curve, group)
    rng = random.Random(seed)
    from gpu_groth16_prover_3x_tpu_torch.host import field as HF
    coords = [[] for _ in range(3 * deg)]
    for col in range(nwin * num):
        if col in ((nwin - 1) * num, 3):
            X, Y, Z = (0,) * deg, (1,) + (0,) * (deg - 1), (0,) * deg
        else:
            x, y = hg.to_affine(hg.mul(rng.randrange(1, 1 << 40),
                                       generator(curve, group)))
            x, y = (x, y) if deg > 1 else ((x,), (y,))
            Z = tuple(rng.randrange(1, p) for _ in range(deg))
            X, Y = HF.e_mul(x, Z, p, alpha), HF.e_mul(y, Z, p, alpha)
        for k in range(deg):
            for j, v in enumerate((X, Y, Z)):
                coords[j * deg + k].append(v[k] * R % p)
    return cops, hg, torch.from_numpy(np.stack([L.ints_to_words(c)
                                                for c in coords]))


@pytest.mark.parametrize("curve,group", GROUPS, ids=IDS)
def test_native_horner_epilogue_equals_finalize_msm(curve, group):
    nwin, num, cbits = 8, 2, 4
    cops, hg, ws = random_window_sums(curve, group, nwin, num, 10)
    got = M.finalize_windows_native(cops, hg, ws, cbits, num)
    want = [M.finalize_msm(hg, pts, cbits)
            for pts in M.window_sums_to_host(cops, ws, num)]
    assert len(got) == num
    for g, w in zip(got, want):
        assert hg.to_affine(g) == hg.to_affine(w)
    # finalize_windows takes the native route, and falls back without it
    assert [hg.to_affine(x) for x in M.finalize_windows(
        cops, hg, ws, cbits, num)] == [hg.to_affine(w) for w in want]


def test_finalize_windows_falls_back_without_library(no_native):
    cops, hg, ws = random_window_sums(MNT4753, "g1", 4, 1, 11)
    assert M.finalize_windows_native(cops, hg, ws, 4) is None
    got, = M.finalize_windows(cops, hg, ws, 4)
    want = M.finalize_msm(hg, M.window_sums_to_host(cops, ws)[0], 4)
    assert hg.to_affine(got) == hg.to_affine(want)
