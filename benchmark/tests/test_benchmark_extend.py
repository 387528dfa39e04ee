"""A later configuration, traffic mix, per-layer metric or kernel count
is new files and new entries in BENCHMARK.json: no file of the benchmark
is edited.  A copy of the benchmark gains a throwaway of each, and a run
of the new cell on the CPU picks them up."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

RUN = """
import json, sys, time
sys.path[:0] = ["benchmark", {root!r}]
from harness import cell, roofline, spec
bench = spec.benchmark()
wl = spec.workload(bench, "tiny-6753.serve-once")
c = cell.Cell(wl, spec.config(wl["config"]), spec.mix(wl["traffic"]),
              2 ** 34 + 9, 0.001, True, "cpu")
out = cell.run_cell(c, bench, time.perf_counter())
out["kernels"] = sorted(spec.kernels())
print(json.dumps(out))
"""


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_metric_and_kernel_are_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    (b / "configs" / "tiny-6753.json").write_text(json.dumps(
        {"curve": "MNT6753", "log2_domain": 4, "reduced": ["log2_domain"],
         "source": "a throwaway for this test"}))
    (b / "mixes" / "serve-once.json").write_text(json.dumps(
        {"entry": "session", "pool_window_factor": 1.0}))
    (b / "metrics" / "ntt.h_share_pct.py").write_text(
        "LAYER, UNIT, MOVES, SOURCE = 'H pipeline', '%', 'proof_s.host', "
        "'program_span'\n\n\ndef read(run):\n"
        "    p = run['proofs'][0]\n"
        "    return 100 * p['laps']['H pipeline (device NTT)'] / "
        "p['latency_s']\n")
    kernel = json.loads((b / "kernels" / "mont_mul.json").read_text())
    kernel.update(launcher="g16_fake", device_name="k_fake")
    (b / "kernels" / "fake.json").write_text(json.dumps(kernel))
    spec_ = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_["configs"].append({"name": "tiny-6753", "source": "test",
                             "file": "benchmark/configs/tiny-6753.json",
                             "reduced": ["log2_domain"], "why": "test"})
    spec_["workloads"].append({"name": "tiny-6753.serve-once",
                               "config": "tiny-6753",
                               "traffic": "serve-once", "chips": 1,
                               "why": "test"})
    spec_["per_layer"].append({"name": "ntt.h_share_pct", "unit": "%",
                               "better": "lower", "source": "program_span",
                               "layer": "H pipeline",
                               "moves": "proof_s.host",
                               "workloads": ["tiny-6753.serve-once"]})
    for m in spec_["end_to_end"]:
        if m["name"] == "proof_s.host":
            m["workloads"].append("tiny-6753.serve-once")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_))
    done = subprocess.run([sys.executable, "-c", RUN.format(root=str(ROOT))],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert 0 < out["metrics"]["ntt.h_share_pct"]["value"] < 100
    assert "ntt.h_s.host" not in out["metrics"]      # not listed there
    assert "fake" in out["kernels"]
    after = _digests(b)
    assert {k: v for k, v in after.items() if k in before} == before
