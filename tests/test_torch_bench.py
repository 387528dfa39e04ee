"""bench_torch.py (the port's bench) and utils/synthetic.py on the CPU:

  (a) the msm and g2 legs build the group elements and scalars of
      bench.py's construction at the same seeds, decoded to integers on
      both sides (the JAX rows through the JAX package's host groups and
      affine_points_to_rows, no JAX device);
  (b), (c) the msm, ntt and g2 legs at tiny sizes report correct: true
      with their documented fields and no rate (a CPU run);
  (d) a wrong window sum makes the msm leg incorrect and main exit
      non-zero with value null;
  (e) main's schedule with stub legs: a leg that raises fails the run, a
      deadline skip does not, the line's keys and value;
  (f) with no card, the bench exits non-zero and prints no value;
  (g) a 2^4 synthetic proof through prove_files equals its known logs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import MNT4753 as JMNT4753
from gpu_groth16_prover_3x_tpu.curves.constants import MNT6753 as JMNT6753
from gpu_groth16_prover_3x_tpu.host import ec as JHE
from gpu_groth16_prover_3x_tpu.ops.msm import affine_points_to_rows
from gpu_groth16_prover_3x_tpu_torch.curves.constants import (MNT4753,
                                                              MNT6753, R)
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

import bench_torch as B

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMINGS = ("first_s", "best_s", "median_s", "all_s")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bench_py_inputs(jcurve, group: str, nbase: int, log2n: int, seed: int):
    """bench.py:97-114 (msm) and :158-167 (g2): host points and rows of
    the JAX package, scalars as (48, n) 16-bit limbs."""
    n = 1 << log2n
    if group == "g1":
        hg, gen, deg = JHE.g1_group(jcurve), JHE.g1_generator(jcurve), 1
    else:
        hg, gen, deg = (JHE.g2_group(jcurve), JHE.g2_generator(jcurve),
                        jcurve.ext_degree)
    base = [hg.to_affine(hg.mul(3 + 7 * i, gen)) for i in range(nbase)]
    base_rows = affine_points_to_rows(base, jcurve.fq.p, deg, bits=16)
    rows = np.tile(base_rows, (n // nbase, 1))
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 16, size=(48, n), dtype=np.uint32)
    keys[47] = rng.integers(0, 2, size=n, dtype=np.uint32)
    return [base[i % nbase] for i in range(n)], rows, keys


def coeff_ints(rows: np.ndarray, ncoef: int, dtype: str) -> list:
    """Rows of ncoef little-endian coefficients -> lists of integers."""
    r = np.ascontiguousarray(rows).astype(dtype).reshape(rows.shape[0],
                                                         ncoef, -1)
    return [[int.from_bytes(c.tobytes(), "little") for c in row]
            for row in r]


@pytest.mark.parametrize("curve,jcurve,group,nbase,log2n,seed", [
    (MNT4753, JMNT4753, "g1", 64, 7, 7),
    (MNT6753, JMNT6753, "g2", 16, 5, 11)], ids=["msm", "g2"])
def test_inputs_equal_bench_py(curve, jcurve, group, nbase, log2n, seed):
    pts, jrows, jkeys = bench_py_inputs(jcurve, group, nbase, log2n, seed)
    ks, rows, keys = B.msm_inputs(curve, group, log2n, nbase, seed)
    assert ks == [3 + 7 * i for i in range(nbase)]
    deg = 1 if group == "g1" else curve.ext_degree
    p = curve.fq.p
    assert rows.shape == (1 << log2n, 2 * deg * L.NWORDS)
    assert rows.dtype == np.int32 and keys.dtype == np.int32
    got = coeff_ints(rows, 2 * deg, "<u4")
    assert got == coeff_ints(jrows, 2 * deg, "<u2")
    rinv = pow(R, -1, p)
    for row, (x, y) in zip(got, pts):
        want = [x, y] if deg == 1 else [*x, *y]
        assert [v * rinv % p for v in row] == list(want)
    assert keys.shape == (L.NWORDS, 1 << log2n)
    jints = [sum(int(jkeys[j, i]) << (16 * j) for j in range(48))
             for i in range(1 << log2n)]
    assert L.words_to_ints(keys) == jints
    assert max(jints) < 1 << 753 and max(jints) >= 1 << 752
    assert SY.tiled_log(ks, keys) == SY.known_log(ks, 1 << log2n, 0, jints)


def check_fields(res: dict, rate_key: str) -> None:
    assert res["correct"] is True
    for k in TIMINGS:
        assert k in res
    assert len(res["all_s"]) == 1 and res["best_s"] == res["all_s"][0]
    assert res[rate_key] is None           # no rate from a CPU run
    assert res["peak_bytes"] is None


def test_msm_leg_cpu():
    res = B.bench_msm(log2n=6, chunk_s=16, c=4, signed=True, reps=1,
                      device="cpu")
    check_fields(res, "points_per_sec")
    assert res["metric"] == "mnt4753_g1_msm_points_per_sec_2^6"
    assert (res["n"], res["c"], res["chunk"], res["signed"]) == \
        (64, 4, 16, True)


def test_ntt_leg_cpu():
    res = B.bench_ntt(log2n=6, reps=1, device="cpu")
    check_fields(res, "ntt_elems_per_sec")
    assert res["metric"] == "mnt4753_fr_ntt_elems_per_sec_2^6"
    assert len(res["sampled_k"]) == 2


def test_g2_leg_cpu():
    res = B.bench_g2(log2n=5, chunk_s=16, c=4, reps=1, device="cpu")
    check_fields(res, "g2_points_per_sec")
    assert res["metric"] == "mnt6753_g2_msm_points_per_sec_2^5"


TINY = {"BENCH_DEVICE": "cpu", "BENCH_INPROCESS": "1", "BENCH_LOG2N": "6",
        "BENCH_CHUNK": "16", "BENCH_REPS": "1", "BENCH_SKIP_PROOF20": "1",
        "BENCH_SKIP_G2": "1", "BENCH_SKIP_NTT": "1",
        "BENCH_PROOF_LOG2D": "0"}


def run_main(monkeypatch, capsys, env: dict):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = B.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(x) for x in lines]


def test_wrong_window_sum_is_caught(monkeypatch, capsys):
    real = M.msm_window_sums

    def one_window_changed(*args, **kwargs):
        ws = real(*args, **kwargs).clone()
        ws[..., 5] = ws[..., 6]
        return ws

    monkeypatch.setattr(M, "msm_window_sums", one_window_changed)
    rc, lines = run_main(monkeypatch, capsys, TINY)
    assert rc != 0
    last = lines[-1]
    assert last["value"] is None
    assert last["detail"]["msm"]["correct"] is False
    assert last["detail"]["device"] == {"platform": "cpu"}


def stub(result=None, error=None):
    def leg(**kwargs):
        if error:
            raise error
        return dict(result, correct=result.get("correct", True))
    return leg


GOOD = {"msm": stub({"points_per_sec": 123.0}), "proof20": stub({}),
        "g2": stub({}), "ntt": stub({}), "proof": stub({})}


@pytest.mark.parametrize("case", ["all-correct", "leg-raises",
                                  "deadline-skip", "msm-incorrect",
                                  "leg-incorrect"])
def test_schedule_with_stub_legs(monkeypatch, capsys, case):
    legs = dict(GOOD)
    env = {"BENCH_DEVICE": "cuda", "BENCH_INPROCESS": "1"}
    if case == "leg-raises":
        legs["g2"] = stub(error=RuntimeError("boom"))
    elif case == "deadline-skip":
        env["BENCH_DEADLINE_S"] = "800"
    elif case == "msm-incorrect":
        legs["msm"] = stub({"points_per_sec": 123.0, "correct": False})
    elif case == "leg-incorrect":
        legs["ntt"] = stub({"correct": False})
    monkeypatch.setattr(B, "LEGS", legs)
    monkeypatch.setattr(B, "device_info", lambda device: {
        "platform": "gpu", "kind": "stub", "count": 1})
    rc, lines = run_main(monkeypatch, capsys, env)
    last = lines[-1]
    assert set(last) == {"metric", "value", "unit", "detail"}
    assert last["metric"] == "mnt4753_g1_msm_points_per_sec_2^20"
    assert last["unit"] == "points/sec"
    detail = last["detail"]
    assert set(B.LEGS) <= set(detail)
    assert len(lines) >= 5                  # a line after every leg
    if case == "all-correct":
        assert rc == 0 and last["value"] == 123.0
    elif case == "leg-raises":
        assert rc != 0 and last["value"] == 123.0
        assert detail["g2"]["correct"] is False
        assert "RuntimeError: boom" in detail["g2"]["error"]
    elif case == "deadline-skip":
        assert rc == 0 and last["value"] == 123.0
        assert detail["proof20"] == {"skipped": "deadline"}
        assert detail["proof"] == {"skipped": "deadline"}
        assert detail["ntt"]["correct"] is True
    elif case == "msm-incorrect":
        assert rc != 0 and last["value"] is None
    else:
        assert rc != 0 and last["value"] == 123.0


def test_no_card_no_value():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA card" in res.stderr


def test_synthetic_proof_equals_known_logs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)            # no table file can be taken
    monkeypatch.delenv("GROTH16_PREPROCESSED_PATH", raising=False)
    rng = np.random.default_rng(5)
    params, inp, ks, logs, values = SY.write_synthetic(MNT4753, 4,
                                                       str(tmp_path), rng)
    out = str(tmp_path / "out")
    GP.prove_files(MNT4753, params, inp, out, device="cpu")
    want = SY.expected_proof(MNT4753, 4, ks, logs, values, "cpu")
    got = SY.read_proof(out, MNT4753)
    assert got == want
    assert got[0] != got[2]
