"""Two separately started processes meet in one torch.distributed group
through env:// (parallel/multihost.initialize reading torchrun's
variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK), and
prove the committed MNT4753 fixture with parallel/prover.prove_sharded
on gloo ranks on the CPU.  The port's counterpart of
tests/test_multihost.py (jax.distributed); each process runs
tests/torch_parallel_ranks.py as a script: the README "Several cards"
recipe with DEVICE = "cpu"."""

import hashlib
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "data", "torch_port")
SCRIPT = os.path.join(ROOT, "tests", "torch_parallel_ranks.py")
TIMEOUT = 300        # seconds for each process


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def committed_sha(curve_name: str) -> str:
    with open(os.path.join(FIX, "SHA256SUMS")) as f:
        return dict(reversed(line.split()) for line in f
                    if line.strip())[f"{curve_name}-output"]


def test_two_processes_env_rendezvous_prove_committed_sha(tmp_path):
    out = tmp_path / "proof"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="2", PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    argv = [sys.executable, SCRIPT, "MNT4753",
            os.path.join(FIX, "MNT4753-parameters"),
            os.path.join(FIX, "MNT4753-input"), str(out)]
    procs = [subprocess.Popen(argv, env=dict(env, RANK=str(r),
                                             LOCAL_RANK=str(r)),
                              cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {procs.index(p)} did not finish within "
                            f"{TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    with open(out, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == \
            committed_sha("MNT4753")
