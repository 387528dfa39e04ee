"""Where the benchmark's data lives, found by the names in BENCHMARK.json.

    benchmark/configs/<config>.json     a configuration: curve and size
    benchmark/mixes/<traffic>.json      a traffic mix: the entry it drives
    benchmark/metrics/<metric>.py       a metric's reader (read(run))
    benchmark/kernels/<kernel>.json     a kernel's work per launch
    benchmark/peaks.json                the card's peak rates

A later cell, mix, metric or kernel is a new file beside these.
"""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent                                   # the checkout


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return _json(HERE / "mixes" / f"{name}.json")


def kernels() -> dict:
    return {p.stem: _json(p) for p in sorted((HERE / "kernels").glob("*.json"))}


def peaks() -> dict:
    return _json(HERE / "peaks.json")


def reader(metric: str):
    """The module benchmark/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, wl_name: str, trace: bool) -> list:
    """The metric entries a run of the workload reports: the end-to-end
    ones with --trace 0, the per-layer ones with --trace 1, each where
    its `workloads` (if given) lists the cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or wl_name in m["workloads"]]
