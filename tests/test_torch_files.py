"""What the port does with damaged parameter and input files, pinned on
the committed fixtures, and the JAX package's bulk readers on the same
bytes (neither reader is changed here):

  - a truncated params or input file raises EOFError: the CLI exits 1;
  - trailing bytes after the payload print a warning and the proof goes
    on (the reference's check_trailing, cuda_prover_piecewise.cu:73-80);
  - an MNT6753 params file read as MNT4753 is longer than an MNT4753 file
    of its d and m would be, so it only warns, and a proof is written.
"""

import hashlib
import os
import subprocess
import sys

import pytest
import torch

from gpu_groth16_prover_3x_tpu.curves.constants import CURVES as JC
from gpu_groth16_prover_3x_tpu.models import tpu_prover as JT
from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.utils import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "data", "torch_port")
WARNING = "WARNING: trailing bytes"


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


def committed_sha(curve_name: str) -> str:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return dict(reversed(line.split()) for line in f
                    if line.strip())[f"{curve_name}-output"]


def damaged(tmp_path, src: str, cut: int = 0, extra: bytes = b"") -> str:
    """A copy of src without its last `cut` bytes and with `extra`
    appended."""
    with open(src, "rb") as f:
        raw = f.read()
    out = tmp_path / (os.path.basename(src) + "-damaged")
    out.write_bytes(raw[:len(raw) - cut] + extra)
    return str(out)


def load_both(curve_name: str, params: str, inp: str = None):
    """The port's and the JAX package's bulk readers on the same files."""
    curve, jcurve = CURVES[curve_name], JC[curve_name]
    p = GP.load_params(params, curve)
    jp = JT.load_params(params, jcurve)
    if inp is not None:
        GP.load_input(inp, curve, p.d, p.m)
        JT.load_input(inp, jcurve, jp.d, jp.m)


@pytest.mark.parametrize("kind", ["parameters", "input"])
def test_truncated_file_exits_1_with_eoferror(kind, tmp_path):
    """One row short (the last 8 bytes gone): the CLI, run as a program,
    exits 1 with EOFError before any output is written; both readers
    raise EOFError on the same bytes."""
    files = {k: fixture("MNT4753", k) for k in ("parameters", "input")}
    files[kind] = damaged(tmp_path, files[kind], cut=8)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_groth16_prover_3x_tpu_torch", "gpu",
         "MNT4753", "compute", files["parameters"], files["input"],
         str(out), "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 1
    assert "EOFError" in proc.stderr
    assert not out.exists()
    with pytest.raises(EOFError):
        load_both("MNT4753", files["parameters"], files["input"])


@pytest.mark.parametrize("kind", ["parameters", "input"])
def test_trailing_bytes_warn_in_both_readers(kind, tmp_path, capsys):
    files = {k: fixture("MNT4753", k) for k in ("parameters", "input")}
    files[kind] = damaged(tmp_path, files[kind], extra=b"\0" * 5)
    load_both("MNT4753", files["parameters"], files["input"])
    err = capsys.readouterr().err
    assert err.count(WARNING) == 2
    assert "gpu_groth16_prover_3x_tpu_torch: WARNING" in err
    assert "gpu_groth16_prover_3x_tpu: WARNING" in err


def test_trailing_bytes_proof_goes_on(tmp_path, capsys):
    """Trailing bytes on the input: a warning, and the proof is the
    committed one."""
    inp = damaged(tmp_path, fixture("MNT4753", "input"), extra=b"\1" * 96)
    out = tmp_path / "out"
    assert cli.main(["gpu", "MNT4753", "compute",
                     fixture("MNT4753", "parameters"), inp, str(out),
                     "--device", "cpu"]) == 0
    assert WARNING in capsys.readouterr().err
    with open(out, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == \
            committed_sha("MNT4753")


def test_mnt6753_params_read_as_mnt4753_only_warn(tmp_path, capsys):
    """The MNT6753 fixture's G2 rows are three coefficients, not two, so
    as an MNT4753 file it has bytes left over: both readers warn and go
    on, and the port's CLI writes a proof (of other points than the
    MNT6753 prover's)."""
    params = fixture("MNT6753", "parameters")
    load_both("MNT4753", params)
    assert capsys.readouterr().err.count(WARNING) == 2
    out = tmp_path / "out"
    assert cli.main(["gpu", "MNT4753", "compute", params,
                     fixture("MNT4753", "input"), str(out),
                     "--device", "cpu"]) == 0
    assert WARNING in capsys.readouterr().err
    assert out.stat().st_size == (2 + 4 + 2) * 96   # A, B over Fq2, C
