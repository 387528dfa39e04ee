"""The port's prover end to end on the CPU (plain versions of every
kernel), against the committed fixtures of tests/data/torch_port:

  MNT{4753,6753}-{parameters,input}: log2 d = 4, made by
      python -m gpu_groth16_prover_3x_tpu generate_parameters \\
          --log2-d-4753 4 --log2-d-6753 4 --seed 42
  SHA256SUMS: sha256 of `cpu <CURVE> compute` (the JAX package's oracle)
      on them.

Also: the JAX containers carried across, CLI strictness, and that the
port imports nothing of JAX."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JCURVES
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.utils import cli

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


def committed_sha() -> dict:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return {name: digest for digest, name in
                (line.split() for line in f if line.strip())}


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def fixture(curve_name: str, kind: str) -> str:
    return os.path.join(FIX, f"{curve_name}-{kind}")


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_port_proof_matches_committed_sha(curve_name, tmp_path):
    out = tmp_path / "out"
    GP.prove_files(CURVES[curve_name], fixture(curve_name, "parameters"),
                   fixture(curve_name, "input"), str(out), device="cpu")
    assert sha(out) == committed_sha()[f"{curve_name}-output"]


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_committed_sha_is_the_jax_cpu_oracle(curve_name, tmp_path):
    """The committed hash re-derived with the JAX package's `cpu`
    oracle, so the fixtures cannot drift."""
    from gpu_groth16_prover_3x_tpu.models import cpu_prover
    out = tmp_path / "out"
    cpu_prover.main_mode(curve_name, "compute",
                         fixture(curve_name, "parameters"),
                         fixture(curve_name, "input"), str(out))
    assert sha(out) == committed_sha()[f"{curve_name}-output"]


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_params_and_input_from_jax(curve_name):
    """The JAX package's loaders (u16 limb rows) carried across equal the
    port's own loaders (u32 word rows), array for array."""
    from gpu_groth16_prover_3x_tpu.models import tpu_prover as JT
    jcurve, curve = JCURVES[curve_name], CURVES[curve_name]
    pf, inf = fixture(curve_name, "parameters"), fixture(curve_name, "input")
    jp = JT.load_params(pf, jcurve)
    ji = JT.load_input(inf, jcurve, jp.d, jp.m)
    mine = GP.load_params(pf, curve)
    carried = GP.params_from_jax(jp)
    assert (carried.d, carried.m) == (mine.d, mine.m)
    for name in ("A", "B1", "B2", "L", "H"):
        assert np.array_equal(getattr(carried, name), getattr(mine, name))
    mi = GP.load_input(inf, curve, mine.d, mine.m)
    ci = GP.input_from_jax(ji)
    for name in ("w_mont", "ca", "cb", "cc"):
        assert np.array_equal(getattr(ci, name), getattr(mi, name))
    assert ci.r == mi.r


@pytest.mark.parametrize("argv", [
    ["gpu", "MNT4753", "compute", "p", "i", "o", "extra"],
    ["gpu", "MNT4753", "compute", "p", "i"],
    ["gpu", "MNT4753", "serve", "p"],               # serve without pairs
    ["gpu", "BN254", "compute", "p", "i", "o"],
    ["tpu", "MNT4753", "compute", "p", "i", "o"],
    ["gpu", "MNT4753", "preprocess", "p", "extra"],
    ["gpu", "MNT4753", "preprocess"],
    ["gpu", "MNT4753", "serve", "p", "i"],
    ["gpu", "MNT4753", "serve", "p", "i", "o", "i2"],
    ["gpu", "MNT4753", "bench", "p"],
    ["cpu", "MNT4753", "compute", "p", "i", "o", "extra"],
    ["cpu", "MNT4753", "compute", "p", "i"],
    ["cpu", "MNT4753", "preprocess", "p", "extra"],
    ["cpu", "MNT4753", "serve", "p", "i", "o"],
    ["cpu", "MNT4753", "compute", "p", "i", "o", "--device", "cpu"],
    ["generate_parameters", "slow"],
    ["generate_parameters", "fast", "extra"],
    ["generate_parameters", "--log2-d-4753", "four"],
], ids=["extra-positional", "missing-output", "no-serve-mode",
        "unknown-curve", "unknown-command", "preprocess-extra-path",
        "preprocess-no-params", "serve-input-without-output",
        "serve-odd-paths", "unknown-mode", "cpu-extra-positional",
        "cpu-missing-output", "cpu-preprocess-extra-path", "cpu-no-serve",
        "cpu-takes-no-device", "generate-unknown-size-word",
        "generate-extra-positional", "generate-size-not-a-number"])
def test_cli_is_strict(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2


def test_cli_cpu_matches_committed_sha(tmp_path):
    out = tmp_path / "out"
    rc = cli.main(["gpu", "MNT4753", "compute",
                   fixture("MNT4753", "parameters"),
                   fixture("MNT4753", "input"), str(out), "--device", "cpu"])
    assert rc == 0
    assert sha(out) == committed_sha()["MNT4753-output"]


def test_port_imports_nothing_of_jax():
    code = (
        "import sys\n"
        "import gpu_groth16_prover_3x_tpu_torch.models.gpu_prover\n"
        "import gpu_groth16_prover_3x_tpu_torch.utils.cli\n"
        "import gpu_groth16_prover_3x_tpu_torch.ops.build\n"
        "import gpu_groth16_prover_3x_tpu_torch.ops.straus\n"
        "import gpu_groth16_prover_3x_tpu_torch.ops.inverse\n"
        "import gpu_groth16_prover_3x_tpu_torch.models.preprocess_device\n"
        "import gpu_groth16_prover_3x_tpu_torch.models.setup\n"
        "import gpu_groth16_prover_3x_tpu_torch.models.setup_device\n"
        "import gpu_groth16_prover_3x_tpu_torch.models.cpu_prover\n"
        "import gpu_groth16_prover_3x_tpu_torch.host.fft\n"
        "import gpu_groth16_prover_3x_tpu_torch.host.msm\n"
        "import gpu_groth16_prover_3x_tpu_torch.host.r1cs\n"
        "import gpu_groth16_prover_3x_tpu_torch.host.groth16\n"
        "import gpu_groth16_prover_3x_tpu_torch.host.pairing\n"
        "import gpu_groth16_prover_3x_tpu_torch.utils.native\n"
        "import gpu_groth16_prover_3x_tpu_torch.utils.serialization\n"
        "import gpu_groth16_prover_3x_tpu_torch.utils.opcount\n"
        "import gpu_groth16_prover_3x_tpu_torch.parallel.multihost\n"
        "import gpu_groth16_prover_3x_tpu_torch.parallel.sharded\n"
        "import gpu_groth16_prover_3x_tpu_torch.parallel.prover\n"
        "import gpu_groth16_prover_3x_tpu_torch.parallel.dryrun\n"
        "import __graft_entry_torch__\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib',"
        " 'gpu_groth16_prover_3x_tpu') or m.startswith("
        "('jax.', 'jaxlib.', 'gpu_groth16_prover_3x_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"
