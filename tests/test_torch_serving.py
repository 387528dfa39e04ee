"""`gpu <CURVE> serve` of the port on the CPU: one parameter set staged
once, two inputs proved against it (the fixture input and a second one
made from a numpy seed), each output byte-identical to a one-shot
`compute` of the same pair; and sessions whose query rows stay in host
memory and go up a block at a time (resident_bytes = 0), which keep the
committed hashes and, slow-tier, the JAX package's ProverSession proofs
with its host-resident rows.  The strictness of the CLI modes is tested
in tests/test_torch_prover.py."""

import hashlib
import os

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.utils import cli
from gpu_groth16_prover_3x_tpu_torch.utils import serialization as ser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "data", "torch_port")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and oversubscribed OpenMP pools stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def fixture(curve_name: str, kind: str) -> str:
    return os.path.join(FIX, f"{curve_name}-{kind}")


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def committed_sha() -> dict:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return {name: digest for digest, name in
                (line.split() for line in f if line.strip())}


def write_random_input(path, curve, d: int, m: int, seed: int) -> None:
    """An input file (generate_parameters.cpp:88-107 layout): w (m+1,
    w[0] = 1), ca, cb, cc (d+1 each) and r, random in Fr."""
    rng = np.random.default_rng(seed)
    fr = curve.fr.p

    def rand():
        return int.from_bytes(rng.bytes(96), "little") % fr

    with open(path, "wb") as f:
        for x in [1] + [rand() for _ in range(m + 3 * (d + 1) + 1)]:
            ser.write_fq(f, x, fr)


@pytest.fixture(scope="module")
def second_pair(tmp_path_factory):
    """A second MNT4753 input made from a seed and the sha256 of its
    one-shot `compute` (rows resident, one pass)."""
    tmp = tmp_path_factory.mktemp("second")
    curve = CURVES["MNT4753"]
    params = fixture("MNT4753", "parameters")
    p = GP.load_params(params, curve)
    second = tmp / "input2"
    write_random_input(second, curve, p.d, p.m, seed=23)
    one_shot = tmp / "one_shot"
    GP.prove_files(curve, params, str(second), str(one_shot), device="cpu")
    return str(second), sha(one_shot)


def serve_two(tmp_path, second: str, capsys):
    """`gpu MNT4753 serve` of the fixture input and `second`; returns the
    two outputs' sha256."""
    curve_name = "MNT4753"
    out1, out2 = tmp_path / "out1", tmp_path / "out2"
    assert cli.main(["gpu", curve_name, "serve",
                     fixture(curve_name, "parameters"),
                     fixture(curve_name, "input"), str(out1), second,
                     str(out2), "--device", "cpu"]) == 0
    laps = capsys.readouterr().out
    assert laps.count("stage params:") == 1
    assert laps.count("prove (serve):") == 2
    return sha(out1), sha(out2)


def test_serve_two_pairs_matches_one_shot_compute(tmp_path, monkeypatch,
                                                  capsys, second_pair):
    """MNT4753 only: serving is the same code for both curves, and three
    plain MNT6753 proofs (G2 over Fq3) take minutes on one thread."""
    monkeypatch.chdir(tmp_path)
    second, one_shot = second_pair
    sha1, sha2 = serve_two(tmp_path, second, capsys)
    # pair 1: the one-shot compute of the fixture is the committed hash
    assert sha1 == committed_sha()["MNT4753-output"]
    assert sha2 == one_shot
    assert sha2 != sha1


def test_serve_host_resident_rows(tmp_path, monkeypatch, capsys,
                                  second_pair):
    """$GROTH16_MSM_RESIDENT_BYTES = 0 and $GROTH16_MSM_BLOCK_POINTS = 48
    (the JAX package's switches): the serve session keeps its rows in
    host memory between the two proofs, each MSM in blocks of 48 points;
    both outputs are those of the resident one-shot computes."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GROTH16_MSM_RESIDENT_BYTES", "0")
    monkeypatch.setenv("GROTH16_MSM_BLOCK_POINTS", "48")
    sessions = []
    init = GP.ProverSession.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        sessions.append(self)
    monkeypatch.setattr(GP.ProverSession, "__init__", keep)
    second, one_shot = second_pair
    sha1, sha2 = serve_two(tmp_path, second, capsys)
    assert sha1 == committed_sha()["MNT4753-output"]
    assert sha2 == one_shot
    sess, = sessions
    assert not sess.resident and sess.block_points == 48
    assert isinstance(sess.g1_rows, np.ndarray)
    assert isinstance(sess.b2_rows, np.ndarray)


@pytest.mark.parametrize("curve_name", ["MNT4753", "MNT6753"])
def test_session_host_resident_rows_in_blocks(curve_name, tmp_path):
    """ProverSession(resident_bytes=0, block_points=48): G1 and B2 rows
    in host memory as contiguous numpy, every MSM in blocks; the proof
    has the committed hash."""
    curve = CURVES[curve_name]
    p = GP.load_params(fixture(curve_name, "parameters"), curve)
    inp = GP.load_input(fixture(curve_name, "input"), curve, p.d, p.m)
    sess = GP.ProverSession(curve, p, device="cpu", resident_bytes=0,
                            block_points=48)
    assert not sess.resident and sess.block_points == 48
    for rows in (sess.g1_rows, sess.b2_rows):
        assert isinstance(rows, np.ndarray) and rows.flags.c_contiguous
    out = tmp_path / "out"
    ser.write_output(out, curve, *sess.prove(inp))
    assert sha(out) == committed_sha()[f"{curve_name}-output"]


def test_resident_and_block_defaults(monkeypatch):
    """resident_bytes: the argument, else the environment, else every
    row on the CPU; block_points: the argument (0 = one pass), else the
    environment, else STREAM_BLOCK past STREAM_ABOVE rows; host rows in
    blocks of at most STREAM_BLOCK."""
    cpu = torch.device("cpu")
    monkeypatch.delenv("GROTH16_MSM_RESIDENT_BYTES", raising=False)
    monkeypatch.delenv("GROTH16_MSM_BLOCK_POINTS", raising=False)
    assert GP.resolve_resident_bytes(None, cpu) == float("inf")
    assert GP.resolve_resident_bytes(5, cpu) == 5
    monkeypatch.setenv("GROTH16_MSM_RESIDENT_BYTES", "7")
    assert GP.resolve_resident_bytes(None, cpu) == 7
    big, small = GP.STREAM_ABOVE + 1, GP.STREAM_ABOVE
    assert GP.resolve_block_points(None, big, True) == GP.STREAM_BLOCK
    assert GP.resolve_block_points(None, small, True) is None
    assert GP.resolve_block_points(0, big, True) is None
    assert GP.resolve_block_points(None, small, False) == GP.STREAM_BLOCK
    assert GP.resolve_block_points(0, small, False) == GP.STREAM_BLOCK
    assert GP.resolve_block_points(1 << 30, big, False) == GP.STREAM_BLOCK
    assert GP.resolve_block_points(48, small, False) == 48
    monkeypatch.setenv("GROTH16_MSM_BLOCK_POINTS", "0")
    assert GP.resolve_block_points(None, big, True) is None
    monkeypatch.setenv("GROTH16_MSM_BLOCK_POINTS", "96")
    assert GP.resolve_block_points(None, small, True) == 96


@pytest.mark.slow
@pytest.mark.parametrize("curve_name", ["MNT4753", "MNT6753"])
def test_host_resident_session_matches_jax_session(curve_name, monkeypatch):
    """The JAX package's ProverSession with its rows in host memory
    ($GROTH16_MSM_RESIDENT_BYTES = 0, blocks of 48 points, XLA:CPU) and
    the port's with resident_bytes = 0 and block_points = 48 give the
    same proof."""
    from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JC
    from gpu_groth16_prover_3x_tpu.models import tpu_prover
    monkeypatch.setenv("GROTH16_MSM_RESIDENT_BYTES", "0")
    monkeypatch.setenv("GROTH16_MSM_BLOCK_POINTS", "48")
    jcurve = JC[curve_name]
    jp = tpu_prover.load_params(fixture(curve_name, "parameters"), jcurve)
    ji = tpu_prover.load_input(fixture(curve_name, "input"), jcurve, jp.d,
                               jp.m)
    jsess = tpu_prover.ProverSession(jcurve, jp, chunk_s=8)
    assert not jsess.resident
    want = jsess.prove(ji)
    sess = GP.ProverSession(CURVES[curve_name], GP.params_from_jax(jp),
                            device="cpu", resident_bytes=0, block_points=48)
    assert sess.prove(GP.input_from_jax(ji)) == tuple(want)
