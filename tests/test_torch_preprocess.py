"""The port's table builder and table path on the CPU, on the committed
fixtures of tests/data/torch_port (see tests/test_torch_prover.py):

  * `gpu <CURVE> preprocess` writes a `<CURVE>_preprocessed` file
    byte-identical to the JAX package's `cpu` oracle (and, in the slow
    tier, to its device builder);
  * `load_preprocessed` reads it as the JAX loader does;
  * `gpu <CURVE> compute` with the file present (in the working
    directory, or named by $GROTH16_PREPROCESSED_PATH) takes the table
    path and reproduces the committed proof hashes.

Every command runs in its own temporary directory: a table file in the
working directory switches `compute` to the table path."""

import hashlib
import os

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


def fixture(curve_name: str, kind: str) -> str:
    return os.path.join(FIX, f"{curve_name}-{kind}")


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def committed_sha() -> dict:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return {name: digest for digest, name in
                (line.split() for line in f if line.strip())}


@pytest.fixture(scope="module")
def table_files(tmp_path_factory):
    """`gpu <CURVE> preprocess` of each fixture, run in a fresh directory
    (the file lands in the working directory, as the reference's does)."""
    out = {}
    cwd = os.getcwd()
    try:
        for name in CURVE_NAMES:
            d = tmp_path_factory.mktemp(f"pre_{name}")
            os.chdir(d)
            assert cli.main(["gpu", name, "preprocess",
                             fixture(name, "parameters"),
                             "--device", "cpu"]) == 0
            out[name] = str(d / f"{name}_preprocessed")
    finally:
        os.chdir(cwd)
    return out


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_preprocess_matches_jax_cpu_oracle(curve_name, table_files,
                                           tmp_path):
    from gpu_groth16_prover_3x_tpu.models import cpu_prover
    want = tmp_path / "jax_cpu_preprocessed"
    cpu_prover.run_preprocess(JCURVES[curve_name],
                              fixture(curve_name, "parameters"), str(want))
    with open(table_files[curve_name], "rb") as f:
        assert f.read() == want.read_bytes()


@pytest.mark.parametrize("curve_name", CURVE_NAMES)
def test_load_preprocessed_matches_jax_loader(curve_name, table_files):
    from gpu_groth16_prover_3x_tpu.models import tpu_prover as JT
    curve = CURVES[curve_name]
    params = GP.load_params(fixture(curve_name, "parameters"), curve)
    nL = params.L.shape[0]
    mine = GP.load_preprocessed(table_files[curve_name], curve, params.m, nL)
    carried = GP.tables_from_jax(JT.load_preprocessed(
        table_files[curve_name], JCURVES[curve_name], params.m, nL))
    deg = curve.ext_degree
    shapes = [(31 * (params.m + 1), 48), (31 * (params.m + 1), 48 * deg),
              (31 * nL, 48)]
    for a, b, shape in zip(mine, carried, shapes):
        assert a.shape == shape and a.dtype == np.int32
        assert np.array_equal(a, b)
    # row 0 of each table is the base row itself (1 * P)
    for t, base in zip(mine, (params.B1, params.B2, params.L)):
        assert np.array_equal(t[:len(base)], base)


@pytest.mark.parametrize("curve_name,switch", [("MNT4753", "cwd"),
                                               ("MNT6753", "env")],
                         ids=["MNT4753-cwd", "MNT6753-env"])
def test_compute_with_tables_matches_committed_sha(
        curve_name, switch, table_files, tmp_path, monkeypatch, capsys):
    if switch == "cwd":
        monkeypatch.chdir(os.path.dirname(table_files[curve_name]))
    else:
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("GROTH16_PREPROCESSED_PATH",
                           table_files[curve_name])
    out = tmp_path / "out"
    assert cli.main(["gpu", curve_name, "compute",
                     fixture(curve_name, "parameters"),
                     fixture(curve_name, "input"), str(out),
                     "--device", "cpu"]) == 0
    assert "load preprocessing:" in capsys.readouterr().out
    assert sha(out) == committed_sha()[f"{curve_name}-output"]


def test_compute_with_tables_host_resident_rows(table_files, tmp_path,
                                                monkeypatch):
    """The table path with $GROTH16_MSM_RESIDENT_BYTES = 0: the A|H rows
    stay in host memory and the A|H pass runs in blocks of 48 points,
    the tables stay as loaded; the proof has the committed hash."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GROTH16_PREPROCESSED_PATH", table_files["MNT4753"])
    monkeypatch.setenv("GROTH16_MSM_RESIDENT_BYTES", "0")
    monkeypatch.setenv("GROTH16_MSM_BLOCK_POINTS", "48")
    sessions = []
    init = GP.ProverSession.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        sessions.append(self)
    monkeypatch.setattr(GP.ProverSession, "__init__", keep)
    out = tmp_path / "out"
    assert cli.main(["gpu", "MNT4753", "compute",
                     fixture("MNT4753", "parameters"),
                     fixture("MNT4753", "input"), str(out),
                     "--device", "cpu"]) == 0
    sess, = sessions
    assert sess.tables is not None and not sess.resident
    assert isinstance(sess.g1_rows, np.ndarray) and sess.block_points == 48
    assert sha(out) == committed_sha()["MNT4753-output"]


@pytest.mark.slow
def test_preprocess_matches_jax_device_builder(table_files, tmp_path):
    """The JAX package's device builder (XLA:CPU) on the same fixture."""
    from gpu_groth16_prover_3x_tpu.models import preprocess_device
    want = tmp_path / "jax_device_preprocessed"
    preprocess_device.run_preprocess(JCURVES["MNT4753"],
                                     fixture("MNT4753", "parameters"),
                                     str(want))
    with open(table_files["MNT4753"], "rb") as f:
        assert f.read() == want.read_bytes()
