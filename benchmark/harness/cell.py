"""One run of one cell: set-up, the measured window, the check, the line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in setup_s, from process start): the keys' distinct rows
(groth16_ref/keys.py), the mix's entry (entries.py: a ProverSession, or
the files and the table file in a work directory), the first input and
one warm-up proof, then the rest of the inputs (pool_size: at most
POOL_MAX_BYTES of them).  The window is a closed loop of one caller:
the next proof starts when the last returns, until --seconds have
passed; a proof started before then is finished and counted, and the
window ends at the last completion.  Then the program's
state is freed and every proof of the window is judged against the
reference (groth16_ref/proof.py): its bytes must equal the expected
proof's.  The metrics are the readers' (benchmark/metrics/) over the run
record; a traced run (--trace 1) also records launches, spans and a
torch.profiler trace of the window and reports the per-layer metrics.
"""

import gc
import json
import math
import resource
import sys
import time
from contextlib import ExitStack

import torch

from groth16_ref import curves as ref_curves
from groth16_ref import keys
from groth16_ref.proof import Reference

from . import entries, spec, trace

BANNED = ("jax", "jaxlib", "flax", "gpu_groth16_prover_3x_tpu")
CONTROLS = ("h-off-by-one",)
POOL_MAX_BYTES = 40e9       # host bytes of the input pool, at most


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of BANNED, compared whole: the port's own name begins with the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Cell:
    def __init__(self, wl: dict, config: dict, mix: dict, seed: int,
                 seconds: float, trace_on: bool, device, control=None):
        from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
        self.name = wl["name"]
        self.mix = mix
        self.curve = CURVES[config["curve"]]
        self.ref_curve = ref_curves.CURVES[config["curve"]]
        self.log2 = config["log2_domain"]
        self.seed, self.seconds, self.trace = seed, seconds, trace_on
        self.device = torch.device(device)
        self.control = control


class ControlEntry:
    """The reference put in the program's place with one guarantee broken
    (CONTROLS): its proofs must come out wrong."""

    def __init__(self, inner, cell):
        self.inner = inner
        self.values = inner.values
        self.ref = Reference(cell.ref_curve, cell.log2, cell.device,
                             with_top_h=True)

    def add_inputs(self, values):
        self.inner.add_inputs(values)

    def before(self):
        pass

    def prove(self, j):
        return self.ref.expect(self.inner.values[j])

    def proof_bytes(self, out):
        return out

    def close(self):
        self.inner.close()


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


class Laps:
    """Host seconds of the set-up's steps, printed as they end."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, label: str) -> float:
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        log(f"{label}: {dt:.3f} s")
        return dt


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pool_size(factor: float, seconds: float, warm: float,
              input_bytes: int) -> tuple:
    """(inputs, capped): the pool's inputs, the warm-up's among them:
    enough fresh witnesses for proofs `factor` times as fast as the
    warm-up over the window, but no more than POOL_MAX_BYTES hold (and
    never under 2); `capped` when that cap binds.  A window that needs
    more inputs than the pool holds starts over."""
    want = math.ceil(factor * seconds / max(warm, 1e-3)) + 2
    cap = max(2, int(POOL_MAX_BYTES // input_bytes))
    return min(want, cap), want > cap


def setup(cell: Cell):
    """The mix's entry with its inputs, warmed up on input 0."""
    from gpu_groth16_prover_3x_tpu_torch.utils.profiling import \
        set_profiling_enabled
    set_profiling_enabled(False)
    lap = Laps()
    base = keys.base_rows(cell.ref_curve)
    lap("set-up: the keys' distinct rows")
    entry = entries.ENTRIES[cell.mix["entry"]](cell, base)
    del base
    if cell.control:
        entry = ControlEntry(entry, cell)
    _sync(cell.device)
    lap(f"set-up: the {cell.mix['entry']} entry (key staged or written)")
    stream = keys.InputStream(cell.ref_curve, cell.log2, cell.seed,
                              cell.device)
    if cell.mix["entry"] == "cli":
        entry.add_inputs([stream.next()
                          for _ in range(cell.mix["input_files"])])
        lap("set-up: the input files")
        entry.before()
        entry.prove(0)                              # warm-up
        _sync(cell.device)
        lap("set-up: the warm-up proof")
    else:
        entry.add_inputs([stream.next()])
        lap("set-up: the first input")
        entry.prove(0)                              # warm-up
        _sync(cell.device)
        warm = lap("set-up: the warm-up proof")
        size = sum(x.nbytes for x in entry.values[0][:4])   # w, ca, cb, cc
        total, capped = pool_size(cell.mix["pool_window_factor"],
                                  cell.seconds, warm, size)
        if capped:
            log(f"set-up: the input pool is capped at {total} inputs of "
                f"{size} B by POOL_MAX_BYTES = {POOL_MAX_BYTES:.0f}")
        count = total - 1
        entry.add_inputs([stream.next() for _ in range(count)])
        lap(f"set-up: {count} more inputs")
    return entry


def window(cell: Cell, entry, first: int) -> dict:
    """The closed loop: inputs first, first + 1, ... in turn."""
    n_in = len(entry.values)
    proofs = []
    launches, spans = trace.Launches(), trace.Spans()
    notes = trace.Annotations()
    from gpu_groth16_prover_3x_tpu_torch.utils.profiling import (
        clear_laps, last_laps)
    with ExitStack() as stack:
        prof = None
        if cell.trace:
            trace.open_patches(stack, launches, spans, notes)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cell.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            stack.enter_context(torch.profiler.record_function(trace.WINDOW))
        w0 = time.perf_counter()
        end = w0
        i = 0
        while i == 0 or time.perf_counter() - w0 < cell.seconds:
            j = (first + i) % n_in
            entry.before()
            clear_laps()
            spans.take()
            t1 = time.perf_counter()
            error = None
            try:
                out = entry.prove(j)
            except Exception as exc:                # a proof that fails
                out, error = None, f"{type(exc).__name__}: {exc}"
            end = time.perf_counter()
            got = None if error else entry.proof_bytes(out)
            proofs.append({"input": j, "latency_s": end - t1, "bytes": got,
                           "error": error, "laps": last_laps(),
                           "spans": spans.take()})
            i += 1
    if prof is not None:
        _sync(cell.device)
        prof.__exit__(None, None, None)
    run = {"window_s": end - w0, "proofs": proofs, "trace": None}
    if prof is not None:
        run["trace"] = dict(trace.read_profile(prof),
                            launches=launches.calls)
    return run


def judge(cell: Cell, run: dict, values: list) -> dict:
    """Every proof of the window against the reference's bytes."""
    ref = Reference(cell.ref_curve, cell.log2, cell.device)
    want = {}
    wrong = missing = 0
    for p in run["proofs"]:
        if p["bytes"] is None:
            missing += 1
            continue
        j = p["input"]
        if j not in want:
            want[j] = ref.expect(values[j])
        if p["bytes"] != want[j]:
            wrong += 1
    return {"proofs_wrong": {"value": wrong, "limit": 0},
            "proofs_missing": {"value": missing, "limit": 0}}


def run_cell(cell: Cell, bench: dict, t_start: float) -> dict:
    """Set-up, window, check and metrics; the result line's object."""
    dev = cell.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    entry = setup(cell)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run = window(cell, entry, 1)        # input 0 was the warm-up's
    run["setup_s"] = setup_s
    if dev.type == "cuda":
        _sync(dev)
        run["device_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    else:
        run["device_peak_bytes"] = None
    values = entry.values
    entry.close()
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if run["trace"] is not None and dev.type == "cuda":
        from .roofline import card_peaks
        run["trace"]["peaks"] = card_peaks(spec.peaks(), dev.index or 0)
        if run["trace"]["peaks"]:
            log(f"card: {run['trace']['peaks'][2]}")
    log("latencies (s): " + " ".join(
        f"{p['latency_s']:.4f}" for p in run["proofs"]))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    checks = judge(cell, run, values)
    peak = (f", card peak {torch.cuda.max_memory_allocated(dev)} B"
            if dev.type == "cuda" else "")
    log(f"judged {len(run['proofs'])} proofs against the reference in "
        f"{time.perf_counter() - t0:.3f} s{peak}; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB")
    attempted = len(run["proofs"])
    failed = checks["proofs_missing"]["value"]
    correct = (attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for m in spec.metrics_for(bench, cell.name, cell.trace):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1,
              "memory_peak_bytes": max(setup_peak,
                                       run["device_peak_bytes"] or 0)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if run["trace"] is not None:
        device["busy_s"] = run["trace"]["busy_s"]
        device["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = run["trace"]["breakdown"]
    errors = [p["error"] for p in run["proofs"] if p["error"]]
    if errors:
        print(f"{len(errors)} proofs raised; the first: {errors[0]}",
              file=sys.stderr)
    out["checks"] = checks
    return out


def report_checks(out: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=CONTROLS, default=None,
                    help="put the reference with a broken guarantee in the "
                         "program's place (its proofs must be judged wrong)")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: needs {wl['chips']} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell = Cell(wl, spec.config(wl["config"]), spec.mix(wl["traffic"]),
                args.seed, args.seconds, bool(args.trace), "cuda:0",
                args.control)
    out = run_cell(cell, bench, t_start)
    found = banned_modules()
    if found:
        print(f"benchmark: loaded {found}: the run must not import JAX or "
              f"the JAX package", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    report_checks(out)
    return 0
