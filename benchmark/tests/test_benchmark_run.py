"""run.py without a card, and what the benchmark may import."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from harness import cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ARGS = ["--workload", "mnt6753-2p15.serve", "--seed", str(2 ** 33 + 1),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = _run(ROOT)
    assert done.returncode != 0
    assert done.stdout == ""
    assert "CUDA" in done.stderr


def test_run_fails_with_only_its_own_files(tmp_path):
    """A checkout of BENCHMARK.json and benchmark/ alone (no program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    done = _run(tmp_path, env)
    assert done.returncode != 0
    assert done.stdout == ""


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    assert cell.banned_modules() == []
    monkeypatch.setitem(sys.modules, "gpu_groth16_prover_3x_tpu_torch_x",
                        object())
    assert cell.banned_modules() == []
    for name in ("jax.numpy", "jaxlib", "flax.linen",
                 "gpu_groth16_prover_3x_tpu.ops.msm"):
        monkeypatch.setitem(sys.modules, name, object())
    assert cell.banned_modules() == ["flax", "gpu_groth16_prover_3x_tpu",
                                     "jax", "jaxlib"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & set(cell.BANNED)
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    allowed = {"numpy", "torch", "dataclasses", "typing"}
    for path in (BENCH / "groth16_ref").glob("*.py"):
        assert _imports(path) <= allowed, path
    code = ("import sys; sys.path.insert(0, 'benchmark'); "
            "import groth16_ref.proof, groth16_ref.keys, groth16_ref.limbs; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          check=True)
    loaded = set(eval(done.stdout.strip().splitlines()[-1]))
    assert not loaded & {"gpu_groth16_prover_3x_tpu_torch", "harness",
                         *cell.BANNED}


@pytest.mark.gpu
def test_cell_on_the_card(need_card):
    """A short run of the smallest cell and of its control on the card:
    the program's proofs are judged right, the control's wrong."""
    import json
    for extra, want in (([], True), (["--control", "h-off-by-one"], False)):
        done = subprocess.run(
            [sys.executable, "benchmark/run.py", *ARGS, *extra], cwd=ROOT,
            capture_output=True, text=True, timeout=900)
        assert done.returncode == 0, done.stderr[-2000:]
        assert json.loads(done.stdout.strip().splitlines()[-1])[
            "correct"] is want
