"""The port's host oracle on the CPU: `cpu <CURVE> compute | preprocess`
against the committed fixtures and the JAX package's `cpu` mode, and the
port's copies of host/fft, host/msm, host/groth16 and host/pairing
against the JAX package's modules on seeded inputs.  Exact equality of
canonical integers and bytes throughout.

The JAX package's own native library builds in place in the repository's
csrc/; its calls here run with that library switched off (its pure-Python
fallbacks), so these tests build nothing there."""

import hashlib
import os
import random

import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JCURVES
from gpu_groth16_prover_3x_tpu.curves.constants import FieldParams as JFP
from gpu_groth16_prover_3x_tpu_torch.curves.constants import (CURVES,
                                                              FieldParams)
from gpu_groth16_prover_3x_tpu_torch.host import ec as HE
from gpu_groth16_prover_3x_tpu_torch.host import fft as HFFT
from gpu_groth16_prover_3x_tpu_torch.host import groth16 as HG
from gpu_groth16_prover_3x_tpu_torch.host import msm as HM
from gpu_groth16_prover_3x_tpu_torch.host import pairing as HP
from gpu_groth16_prover_3x_tpu_torch.utils import cli
from gpu_groth16_prover_3x_tpu_torch.utils import serialization as SER

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "data", "torch_port")
CURVE_NAMES = ["MNT4753", "MNT6753"]


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


def fixture(curve_name: str, kind: str) -> str:
    return os.path.join(FIX, f"{curve_name}-{kind}")


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def committed_sha() -> dict:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return {name: digest for digest, name in
                (line.split() for line in f if line.strip())}


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_cpu_compute_matches_committed_sha(curve_name, tmp_path):
    out = tmp_path / "out"
    assert cli.main(["cpu", curve_name, "compute",
                     fixture(curve_name, "parameters"),
                     fixture(curve_name, "input"), str(out)]) == 0
    assert sha(out) == committed_sha()[f"{curve_name}-output"]


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_cpu_preprocess_matches_jax_cpu_preprocess(curve_name, tmp_path,
                                                   monkeypatch):
    from gpu_groth16_prover_3x_tpu.models import cpu_prover as JCP
    want = tmp_path / "jax_preprocessed"
    JCP.run_preprocess(JCURVES[curve_name], fixture(curve_name, "parameters"),
                       str(want))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["cpu", curve_name, "preprocess",
                     fixture(curve_name, "parameters")]) == 0
    assert (tmp_path / f"{curve_name}_preprocessed").read_bytes() == \
        want.read_bytes()


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_host_readers_match_jax(curve_name):
    from gpu_groth16_prover_3x_tpu.utils import serialization as JS
    curve, jcurve = CURVES[curve_name], JCURVES[curve_name]
    mine = SER.read_params(fixture(curve_name, "parameters"), curve)
    theirs = JS.read_params(fixture(curve_name, "parameters"), jcurve)
    assert mine.__dict__ == theirs.__dict__
    mi = SER.read_input(fixture(curve_name, "input"), curve, mine.d, mine.m)
    ti = JS.read_input(fixture(curve_name, "input"), jcurve, mine.d, mine.m)
    assert mi.__dict__ == ti.__dict__


def small_field(cls, p, s, t, q=None):
    """Tiny field with p - 1 = 2^s * t (as tests/test_host_fft.py builds
    them), as the port's or the JAX package's FieldParams."""
    g = next(g for g in range(2, p)
             if all(pow(g, (p - 1) // f, p) != 1 for f in (2, t)))
    return cls(p=p, s=s, t=t, multiplicative_generator=g,
               root_of_unity=pow(g, t, p), nqr=g, small_subgroup_base=q,
               small_subgroup_power=1 if q else None,
               full_root_of_unity=g if q else None)


@pytest.mark.parametrize("field,size", [
    ("F449", 16), ("F449", 128), ("F449", 20), ("F449", 21), ("F449M", 28),
    ("F23", 6), ("MNT4753", 16), ("MNT6753", 16), ("MNT4753", 64),
    ("MNT6753", 64)])
def test_fft_domains_match_jax(field, size):
    """get_evaluation_domain and every transform of the chosen domain
    (basic, extended, step, mixed radix, sequence; 64 points take the
    port's native FFT and the JAX package's Python loops)."""
    from gpu_groth16_prover_3x_tpu.host import fft as JFFT
    if field.startswith("MNT"):
        fp, jfp = CURVES[field].fr, JCURVES[field].fr
    else:
        spec = {"F449": (449, 6, 7), "F449M": (449, 6, 7, 7),
                "F23": (23, 1, 11)}[field]
        fp, jfp = small_field(FieldParams, *spec), small_field(JFP, *spec)
    dom = HFFT.get_evaluation_domain(fp, size)
    jdom = JFFT.get_evaluation_domain(jfp, size)
    assert type(dom).__name__ == type(jdom).__name__ and dom.m == jdom.m
    rng = random.Random(size)
    a = [rng.randrange(fp.p) for _ in range(dom.m)]
    t = rng.randrange(fp.p)
    for name in ("fft", "ifft", "coset_fft", "icoset_fft",
                 "divide_by_z_on_coset"):
        assert getattr(dom, name)(list(a)) == getattr(jdom, name)(list(a))
    assert dom.evaluate_all_lagrange_polynomials(t) == \
        jdom.evaluate_all_lagrange_polynomials(t)
    assert dom.compute_vanishing_polynomial(t) == \
        jdom.compute_vanishing_polynomial(t)


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_compute_h_matches_jax(curve_name):
    from gpu_groth16_prover_3x_tpu.host import groth16 as JG
    curve = CURVES[curve_name]
    params = SER.read_params(fixture(curve_name, "parameters"), curve)
    inp = SER.read_input(fixture(curve_name, "input"), curve, params.d,
                         params.m)
    assert HG.compute_h(curve, params.d, inp.ca, inp.cb, inp.cc) == \
        JG.compute_h(JCURVES[curve_name], params.d, inp.ca, inp.cb, inp.cc)


@pytest.mark.parametrize("curve_name,group", [
    ("MNT4753", "g1"), ("MNT4753", "g2"), ("MNT6753", "g1"),
    ("MNT6753", "g2")])
def test_msm_matches_jax(curve_name, group):
    """64 points: the port's native g16_msm against the JAX package's
    Python buckets, and the port's Python buckets (48 points)."""
    from gpu_groth16_prover_3x_tpu.host import ec as JE
    from gpu_groth16_prover_3x_tpu.host import msm as JM
    curve, jcurve = CURVES[curve_name], JCURVES[curve_name]
    hg = HE.g1_group(curve) if group == "g1" else HE.g2_group(curve)
    jg = JE.g1_group(jcurve) if group == "g1" else JE.g2_group(jcurve)
    gen = HE.g1_generator(curve) if group == "g1" else HE.g2_generator(curve)
    rng = random.Random(21)
    pts = [hg.mul(rng.randrange(1, 1 << 40), gen) for _ in range(64)]
    sc = [rng.randrange(1 << 160) for _ in pts]
    for n in (64, 48):
        assert hg.to_affine(HM.msm(hg, sc[:n], pts[:n])) == \
            jg.to_affine(JM.msm(jg, sc[:n], pts[:n]))


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_pairing_matches_jax(curve_name):
    from gpu_groth16_prover_3x_tpu.host import pairing as JP
    curve, jcurve = CURVES[curve_name], JCURVES[curve_name]
    rng = random.Random(31)
    P = HE.g1_group(curve).mul(rng.randrange(2, 1 << 64),
                               HE.g1_generator(curve))
    Q = HE.g2_group(curve).mul(rng.randrange(2, 1 << 64),
                               HE.g2_generator(curve))
    assert HP.reduced_pairing(curve, P, Q) == \
        JP.reduced_pairing(jcurve, P, Q)


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_verify_full_prove_and_tampered(curve_name):
    """setup -> derive_keys -> full_prove -> verify (pairings), as
    tests/test_pairing.py does for the JAX package; a tampered proof or
    public input is rejected, and the challenge proof of the same setup
    passes verify_with_trapdoor."""
    curve = CURVES[curve_name]
    res = HG.setup(curve, 4, random.Random(11))
    vk, pk = HG.derive_keys(curve, res)
    proof = HG.full_prove(curve, res, pk, rng=random.Random(12))
    primary = [res.w[1]]
    assert HG.verify(curve, vk, primary, proof)
    assert not HG.verify(curve, vk, [primary[0] + 1], proof)
    bad = ((proof[0][0] + 1, proof[0][1]), proof[1], proof[2])
    assert not HG.verify(curve, vk, primary, bad)
    inp = SER.Groth16Input(res.w, res.ca, res.cb, res.cc, res.r)
    params = SER.Groth16Params(res.d, res.m, res.A, res.B1, res.B2, res.L,
                               res.H)
    challenge = HG.prove(curve, params, inp)
    assert HG.verify_with_trapdoor(curve, res, *challenge)
    assert not HG.verify_with_trapdoor(curve, res, challenge[0],
                                       challenge[1], challenge[0])
