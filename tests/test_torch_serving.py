"""`gpu <CURVE> serve` of the port on the CPU: one parameter set staged
once, two inputs proved against it (the fixture input and a second one
made from a numpy seed), each output byte-identical to a one-shot
`compute` of the same pair.  The strictness of the CLI modes is tested
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


def test_serve_two_pairs_matches_one_shot_compute(tmp_path, monkeypatch,
                                                  capsys):
    """MNT4753 only: serving is the same code for both curves, and three
    plain MNT6753 proofs (G2 over Fq3) take minutes on one thread."""
    curve_name = "MNT4753"
    monkeypatch.chdir(tmp_path)
    curve = CURVES[curve_name]
    params = fixture(curve_name, "parameters")
    p = GP.load_params(params, curve)
    second = tmp_path / "input2"
    write_random_input(second, curve, p.d, p.m, seed=23)
    out1, out2 = tmp_path / "out1", tmp_path / "out2"
    assert cli.main(["gpu", curve_name, "serve", params,
                     fixture(curve_name, "input"), str(out1),
                     str(second), str(out2), "--device", "cpu"]) == 0
    laps = capsys.readouterr().out
    assert laps.count("stage params:") == 1
    assert laps.count("prove (serve):") == 2
    # pair 1: the one-shot compute of the fixture is the committed hash
    assert sha(out1) == committed_sha()[f"{curve_name}-output"]
    one_shot = tmp_path / "one_shot"
    GP.prove_files(curve, params, str(second), str(one_shot), device="cpu")
    assert sha(out2) == sha(one_shot)
    assert sha(out2) != sha(out1)
