"""Benchmark of the PyTorch/CUDA prover: MNT4753 G1 MSM throughput and
whole-proof latency, each leg checked for a correct result.

    python3 bench_torch.py                       # on a CUDA card
    BENCH_DEVICE=cpu BENCH_INPROCESS=1 BENCH_LOG2N=6 BENCH_CHUNK=16 \\
        BENCH_SKIP_PROOF20=1 BENCH_G2_LOG2N=5 BENCH_NTT_LOG2N=6 \\
        BENCH_PROOF_LOG2D=0 BENCH_REPS=1 python3 bench_torch.py

The counterpart of bench.py (the JAX package's bench) for the port.  It
streams one cumulative JSON line per completed leg; the LAST printed
line is the result:

  {"metric": "mnt4753_g1_msm_points_per_sec_2^20", "value": N or null,
   "unit": "points/sec",
   "detail": {"device": {...}, "msm": {...}, "proof20": {...},
              "g2": {...}, "ntt": {...}, "proof": {...}, ...}}

Legs, in value order (later legs are skipped once the deadline
BENCH_DEADLINE_S is near):

  msm      MNT4753 G1 window sums of 2^BENCH_LOG2N points (the value)
  proof20  MNT4753 proof at d + 1 = 2^20 (the reference's default size)
           from synthetic keys with known discrete logs: cold, then
           warm runs with the phase split, then a ProverSession
  g2       MNT6753 G2 (Fq3) window sums of 2^BENCH_G2_LOG2N points
  ntt      MNT4753 Fr forward NTT of 2^BENCH_NTT_LOG2N elements
  proof    MNT4753 proof at 2^BENCH_PROOF_LOG2D from real keys
           (generate_parameters on the device, cached)

Every leg checks its result outside the timed runs and reports
"correct"; `value` is null unless the msm leg completed correct on a
card.  The exit code is 0 only when every leg that ran is correct (a
leg skipped for the deadline or a BENCH_SKIP_* knob does not count).

Timing: the first call (kernel build or load, warm-up) is `first_s`;
then BENCH_REPS runs, each a host clock around work that ends in
torch.cuda.synchronize(), give `best_s`, `median_s` and `all_s`;
`peak_bytes` is torch.cuda.max_memory_allocated over the leg and
`launches` the kernel launches of its timed calls, first call included.

Each leg group runs in its own subprocess, one after the other (a CUDA
fault poisons the context of the process that hit it, and the other
groups must still report); the parent reads each leg's marked line as
it arrives and prints the cumulative line again.

Env knobs: BENCH_DEVICE (cuda; cpu only for rehearsals: no rate is
reported and `value` stays null), BENCH_DEADLINE_S (3300), BENCH_LOG2N
(20), BENCH_CHUNK (128), BENCH_REPS (3), BENCH_SIGNED (1),
BENCH_PROOF_LOG2D (16; 0 turns the leg off), BENCH_G2_LOG2N (15),
BENCH_NTT_LOG2N (20), BENCH_SKIP_PROOF20, BENCH_SKIP_G2, BENCH_SKIP_NTT,
BENCH_SKIP_PROOF, BENCH_SKIP_SERVE, BENCH_INPROCESS=1 (no
subprocesses).  Window width c: 16 on a card (as bench.py), 4 on the
CPU.  Files go under .bench_cache/torch/.
"""

import contextlib
import json
import os
import queue
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from gpu_groth16_prover_3x_tpu_torch.curves.constants import (  # noqa: E402
    MNT4753, MNT6753, get_root_of_unity)
from gpu_groth16_prover_3x_tpu_torch.host import ec as HE  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.host import groth16 as HG  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP  # noqa
from gpu_groth16_prover_3x_tpu_torch.models import setup as SU  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import mont_mul as MM  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops.ntt import (  # noqa: E402
    NttPlan, intt, ntt)
from gpu_groth16_prover_3x_tpu_torch.utils import profiling  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils import \
    synthetic as SY  # noqa: E402

CACHE = os.path.join(ROOT, ".bench_cache", "torch")
LEG_MARK = "BENCH_LEG_RESULT "
# the kernel wrappers' launch counters (a CUDA launch adds one; the plain
# route on the CPU adds none)
COUNTERS = {"mont_mul": MM.MONT_MUL, "ec_add": GK.EC_ADD, "ec_dbl": GK.EC_DBL,
            "ec_mixed_add": GK.EC_MIXED_ADD, "msm_scan": M.MSM_SCAN}


# -- timing -------------------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return None


def timed_runs(fn, reps: int, device):
    """fn() once (first_s), then `reps` times; each run a host clock
    around fn() and a synchronise.  Returns (last output, timings and the
    kernel launches of all the runs)."""
    if reps < 1:
        raise ValueError(f"reps must be at least 1, not {reps}")

    def once():
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        return out, time.perf_counter() - t0

    before = {n: k.launches for n, k in COUNTERS.items()}
    out, first = once()
    times = []
    for _ in range(reps):
        out, t = once()
        times.append(t)
    return out, {"first_s": first, "best_s": min(times),
                 "median_s": statistics.median(times), "all_s": times,
                 "launches": {n: k.launches - before[n]
                              for n, k in COUNTERS.items()}}


def _rate(n: int, t: dict, device):
    """n / best_s on a card; a CPU run reports no rate."""
    return n / t["best_s"] if torch.device(device).type == "cuda" else None


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@contextlib.contextmanager
def _in_dir(path: str):
    """Run in `path`: prove_files takes a `<CURVE>_preprocessed` file in
    the working directory as the table path's tables."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


# -- the MSM legs -------------------------------------------------------------

def msm_inputs(curve, group: str, log2n: int, nbase: int, seed: int):
    """bench.py's inputs in the port's layout: rows tiling the affine
    multiples (3 + 7i) * G, i < nbase, and scalars from
    default_rng(seed) drawn as (48, n) 16-bit limbs with one live bit in
    limb 47, packed into (24, n) int32 words (word i = limb 2i | limb
    2i+1 << 16).  Returns (ks, rows, keys)."""
    n = 1 << log2n
    if n % nbase:
        raise ValueError(f"2^{log2n} points do not tile {nbase} bases")
    ks = [3 + 7 * i for i in range(nbase)]
    rows = SY.multiples_rows(curve, group, ks)[np.arange(n) % nbase]
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(48, n), dtype=np.uint32)
    # one live bit in the top limb, like a real scalar below r ~ 2^753
    limbs[47] = rng.integers(0, 2, size=n, dtype=np.uint32)
    keys = (limbs[0::2] | (limbs[1::2] << 16)).view(np.int32)
    return ks, np.ascontiguousarray(rows), np.ascontiguousarray(keys)


def _msm_leg(curve, group: str, log2n: int, nbase: int, seed: int,
             chunk_s: int, c: int, signed: bool, reps: int, device) -> dict:
    """Time msm_window_sums on inputs already on the device; check the
    window sums' Horner recombination against the known log."""
    cops = get_curve_ops(curve, group)
    if group == "g1":
        hg, gen = HE.g1_group(curve), HE.g1_generator(curve)
    else:
        hg, gen = HE.g2_group(curve), HE.g2_generator(curve)
    ks, rows, keys = msm_inputs(curve, group, log2n, nbase, seed)
    rows_d = torch.from_numpy(rows).to(device)
    keys_d = torch.from_numpy(keys).to(device)
    _reset_peak(device)
    ws, t = timed_runs(lambda: M.msm_window_sums(
        cops, keys_d, rows_d, chunk_s, c=c, signed=signed), reps, device)
    peak = _peak(device)
    got, = M.finalize_windows(cops, hg, ws, c)
    want = hg.mul(SY.tiled_log(ks, keys) % curve.fr.p, gen)
    return dict(t, n=1 << log2n, log2n=log2n, chunk=chunk_s, c=c,
                signed=signed, peak_bytes=peak,
                correct=bool(hg.equal(got, want) and not hg.is_zero(got)))


def bench_msm(*, log2n: int = 20, chunk_s: int = 128, c: int = 16,
              signed: bool = True, reps: int = 3, seed: int = 7,
              device="cuda") -> dict:
    """MNT4753 G1 MSM (bench.py:83-142): 2^log2n points tiled from 64
    multiples, scalars from default_rng(seed)."""
    res = _msm_leg(MNT4753, "g1", log2n, 64, seed, chunk_s, c, signed,
                   reps, device)
    res["metric"] = f"mnt4753_g1_msm_points_per_sec_2^{log2n}"
    res["points_per_sec"] = _rate(res["n"], res, device)
    return res


def bench_g2(*, log2n: int = 15, chunk_s: int = 128, c: int = 16,
             reps: int = 3, seed: int = 11, device="cuda") -> dict:
    """MNT6753 G2 MSM over Fq3 (bench.py:145-192): 2^log2n points tiled
    from 16 multiples, signed digits."""
    res = _msm_leg(MNT6753, "g2", log2n, 16, seed, chunk_s, c, True, reps,
                   device)
    res["metric"] = f"mnt6753_g2_msm_points_per_sec_2^{log2n}"
    res["g2_points_per_sec"] = _rate(res["n"], res, device)
    return res


# -- the NTT leg --------------------------------------------------------------

def ntt_input(log2n: int, seed: int):
    """bench.py's NTT input: default_rng(seed) (48, n) 16-bit limbs with
    the top two zero (so each value is below p), as (24, n) words; and
    two output indices to check, drawn after it."""
    n = 1 << log2n
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(48, n), dtype=np.uint32)
    limbs[46:] = 0
    x = (limbs[0::2] | (limbs[1::2] << 16)).view(np.int32)
    return np.ascontiguousarray(x), [int(k) for k in
                                     rng.integers(0, n, size=2)]


def bench_ntt(*, log2n: int = 20, reps: int = 3, seed: int = 13,
              device="cuda") -> dict:
    """MNT4753 Fr forward NTT (bench.py:195-232), ntt(plan, x,
    plan.tw_fwd).  Check: intt(ntt(x)) == x word for word, and two
    outputs equal the host sums sum_j x_j omega^(jk) mod p (the
    transform is linear, so it holds on the words whatever their
    domain)."""
    fr = MNT4753.fr
    n = 1 << log2n
    x, sample = ntt_input(log2n, seed)
    plan = NttPlan(fr, n, device)
    x_d = torch.from_numpy(x).to(device)
    _reset_peak(device)
    y, t = timed_runs(lambda: ntt(plan, x_d, plan.tw_fwd), reps, device)
    peak = _peak(device)
    back = bool(torch.equal(intt(plan, y), x_d))
    xs = L.words_to_ints(x)
    ys = L.words_to_ints(y[:, sample].cpu().numpy())
    omega = get_root_of_unity(fr, n)
    sums = []
    for k in sample:
        wk, acc = pow(omega, k, fr.p), 0
        for v in reversed(xs):              # Horner in omega^k
            acc = (acc * wk + v) % fr.p
        sums.append(acc)
    return dict(t, metric=f"mnt4753_fr_ntt_elems_per_sec_2^{log2n}",
                n=n, log2n=log2n,
                ntt_elems_per_sec=_rate(n, t, device), peak_bytes=peak,
                sampled_k=sample, correct=back and ys == sums)


# -- the proof legs -----------------------------------------------------------

def _prove_timed(curve, params: str, inp: str, reps: int, device,
                 check) -> dict:
    """prove_files cold, then `reps` warm runs, in a directory of its own,
    each to its own output.  `check(path)` holds the first output; every
    later one must equal it byte for byte.  The phases are the last
    run's block laps."""
    with tempfile.TemporaryDirectory(dir=CACHE) as work, _in_dir(work):
        outs = []

        def prove():
            outs.append(os.path.join(work, f"output-{len(outs)}"))
            profiling.clear_laps()
            GP.prove_files(curve, params, inp, outs[-1], device=device)

        _reset_peak(device)
        t = timed_runs(prove, reps, device)[1]
        laps = profiling.last_laps()
        peak = _peak(device)
        first = _read(outs[0])
        same = all(_read(o) == first for o in outs[1:])
        correct = bool(check(outs[0])) and same
    return dict(t, phases=laps, peak_bytes=peak, correct=correct)


def bench_proof20(*, log2d: int = 20, reps: int = 3, seed: int = 20,
                  serve: bool = True, device="cuda") -> dict:
    """MNT4753 proof at d + 1 = 2^log2d through prove_files, from
    synthetic parameters (cached, written then renamed) and an input
    from default_rng(seed); A, B and C checked against the known logs.
    With `serve`, a ProverSession on the same files: stage, first and
    warm proof, both checked."""
    curve = MNT4753
    os.makedirs(CACHE, exist_ok=True)
    params = os.path.join(CACHE, f"MNT4753-synthetic-parameters-{log2d}")
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(dir=CACHE) as work:
        t0 = time.perf_counter()
        inp = os.path.join(work, "input")
        if not os.path.isfile(params):
            tmp = os.path.join(work, "parameters")
            SY.write_params(curve, log2d, tmp)
            os.replace(tmp, params)
        values = SY.write_input(curve, log2d, inp, rng)
        files_s = time.perf_counter() - t0
        want = SY.expected_proof(curve, log2d, SY.KS, SY.query_logs(log2d),
                                 values, device)
        out = _prove_timed(curve, params, inp, reps, device,
                           lambda path: SY.read_proof(path, curve) == want)
        out.update(metric=f"mnt4753_proof_seconds_2^{log2d}", log2d=log2d,
                   keys="synthetic", files_s=files_s)
        if serve:
            p = GP.load_params(params, curve)
            inputs = GP.load_input(inp, curve, p.d, p.m)
            t0 = time.perf_counter()
            sess = GP.ProverSession(curve, p, device)
            _sync(device)
            stage_s = time.perf_counter() - t0
            proofs = []
            t = timed_runs(lambda: proofs.append(sess.prove(inputs)), 1,
                           device)[1]
            out["serve"] = {"stage_s": stage_s, "first_s": t["first_s"],
                            "warm_s": t["best_s"]}
            out["correct"] = out["correct"] and all(
                tuple(map(tuple, pr)) == want for pr in proofs)
    return out


def bench_proof(*, log2d: int = 16, reps: int = 3, seed: int = 0xBE7C,
                device="cuda") -> dict:
    """MNT4753 proof at d + 1 = 2^log2d from real keys
    (generate_parameters on `device` with a trapdoor, cached, written
    then renamed), checked by verify_with_trapdoor."""
    curve = MNT4753
    os.makedirs(CACHE, exist_ok=True)
    names = ("parameters", "input", "trapdoor")
    paths = [os.path.join(CACHE, f"MNT4753-{k}-{log2d}") for k in names]
    gen_s = None
    if not all(os.path.isfile(p) for p in paths):
        t0 = time.perf_counter()
        SU.generate_parameters(curve, log2d, paths[0] + ".tmp",
                               paths[1] + ".tmp", seed=seed,
                               trapdoor_path=paths[2] + ".tmp",
                               device=device)
        for p in paths:
            os.replace(p + ".tmp", p)
        gen_s = time.perf_counter() - t0
    params, inp, td = paths
    result = SU.trapdoor_result(curve, td, inp)
    out = _prove_timed(curve, params, inp, reps, device,
                       lambda path: HG.verify_with_trapdoor(
                           curve, result, *SY.read_proof(path, curve)))
    out.update(metric=f"mnt4753_proof_seconds_2^{log2d}", log2d=log2d,
               keys="real", param_gen_s=gen_s)
    return out


LEGS = {"msm": bench_msm, "proof20": bench_proof20, "g2": bench_g2,
        "ntt": bench_ntt, "proof": bench_proof}


def leg_kwargs(name: str, env, device: str, remaining_s: float) -> dict:
    """A leg's keyword arguments from the environment knobs;
    `remaining_s` is the budget left to the run."""
    reps = int(env.get("BENCH_REPS", "3"))
    chunk = int(env.get("BENCH_CHUNK", "128"))
    c = 16 if device == "cuda" else 4
    if name == "msm":
        return dict(log2n=int(env.get("BENCH_LOG2N", "20")), chunk_s=chunk,
                    c=c, signed=bool(int(env.get("BENCH_SIGNED", "1"))),
                    reps=reps, device=device)
    if name == "g2":
        return dict(log2n=int(env.get("BENCH_G2_LOG2N", "15")),
                    chunk_s=chunk, c=c, reps=reps, device=device)
    if name == "ntt":
        return dict(log2n=int(env.get("BENCH_NTT_LOG2N", "20")), reps=reps,
                    device=device)
    if name == "proof20":
        return dict(reps=reps, device=device,
                    serve=not env.get("BENCH_SKIP_SERVE")
                    and remaining_s > 600)
    if name == "proof":
        return dict(log2d=int(env.get("BENCH_PROOF_LOG2D", "16")),
                    reps=reps, device=device)
    raise ValueError(f"unknown leg {name!r}")


def run_leg(name: str, env, device: str, remaining_s: float) -> dict:
    """One leg; its prints go to stderr, an exception becomes an
    incorrect result."""
    try:
        with contextlib.redirect_stdout(sys.stderr):
            return LEGS[name](**leg_kwargs(name, env, device, remaining_s))
    except Exception as e:  # noqa: BLE001 -- report, not die
        return {"error": f"{type(e).__name__}: {e}"[:300], "correct": False}


# -- subprocesses -------------------------------------------------------------

def _child_main(leg_names) -> int:
    """Run the named legs in this process, one marked JSON line each."""
    device = os.environ.get("BENCH_DEVICE", "cuda")
    start = time.time()
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "3300"))
    for name in leg_names:
        res = run_leg(name, os.environ, device,
                      deadline - (time.time() - start))
        print(LEG_MARK + json.dumps({"leg": name, "result": res}),
              flush=True)
    return 0


def _run_group(leg_names, timeout_s: float, remaining_s: float,
               on_leg) -> set:
    """One subprocess running `leg_names`; on_leg(name, result) as each
    marked line arrives.  The child is killed at timeout_s; its stderr
    passes through.  Returns the legs that gave a result."""
    done = set()
    env = dict(os.environ)
    # the child's deadline guards see the parent's remaining budget
    env["BENCH_DEADLINE_S"] = str(max(60.0, remaining_s))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--legs",
         ",".join(leg_names)], stdout=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    lines = queue.Queue()

    def reader():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=reader, daemon=True).start()
    end = time.time() + timeout_s
    try:
        while True:
            try:
                line = lines.get(timeout=max(0.1, min(5.0,
                                                      end - time.time())))
            except queue.Empty:
                if time.time() >= end:
                    print(f"bench group {leg_names}: timeout after "
                          f"{timeout_s:.0f} s, killing", file=sys.stderr,
                          flush=True)
                    break
                continue
            if line is None:
                break
            if line.startswith(LEG_MARK):
                rec = json.loads(line[len(LEG_MARK):])
                done.add(rec["leg"])
                on_leg(rec["leg"], rec["result"])
    finally:
        proc.kill()
        proc.wait()
    return done


# -- the parent ---------------------------------------------------------------

def device_info(device: str) -> dict:
    """What the line says of the device; raises when BENCH_DEVICE=cuda
    finds no card (there is no CPU fallback)."""
    if device == "cpu":
        return {"platform": "cpu"}
    if device != "cuda":
        raise ValueError(f"BENCH_DEVICE must be cuda or cpu, not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("BENCH_DEVICE=cuda and no CUDA card")
    card = profiling.card_line()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "card": card,
            "power_limit": card.rsplit(",", 1)[-1].strip()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--legs":
        return _child_main(argv[1].split(","))
    start = time.time()
    env = os.environ
    deadline = float(env.get("BENCH_DEADLINE_S", "3300"))
    device = env.get("BENCH_DEVICE", "cuda")
    try:
        detail = {"device": device_info(device), "deadline_s": deadline}
    except (RuntimeError, ValueError, OSError,
            subprocess.CalledProcessError) as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 1
    # the table path is not benchmarked: no table file may switch to it
    env.pop("GROTH16_PREPROCESSED_PATH", None)
    inproc = bool(env.get("BENCH_INPROCESS"))
    log2n = int(env.get("BENCH_LOG2N", "20"))
    state = {"value": None}

    def remaining() -> float:
        return deadline - (time.time() - start)

    def emit():
        detail["elapsed_s"] = time.time() - start
        print(json.dumps({
            "metric": f"mnt4753_g1_msm_points_per_sec_2^{log2n}",
            "value": state["value"], "unit": "points/sec",
            "detail": detail}), flush=True)

    def on_leg(name, res):
        detail[name] = res
        if name == "msm" and res.get("correct"):
            state["value"] = res.get("points_per_sec")
        emit()

    def run(leg_names, timeout_s):
        if inproc:
            for name in leg_names:
                on_leg(name, run_leg(name, env, device, remaining()))
            return set(leg_names)
        return _run_group(leg_names, min(timeout_s, max(0.0, remaining())),
                          remaining(), on_leg)

    def skip(leg_names, why):
        for name in leg_names:
            detail[name] = {"skipped": why}
        emit()

    def run_or_fail(leg_names, timeout_s, retry=False):
        done = run(leg_names, timeout_s)
        lost = [n for n in leg_names if n not in done]
        if lost and retry and remaining() > 600:
            done |= run(lost, timeout_s)
            lost = [n for n in leg_names if n not in done]
        for name in lost:
            on_leg(name, {"error": "no result: the group's process timed "
                          "out or died", "correct": False})

    # -- leg schedule, value order (bench.py:456-500) -------------------------
    # 1. the value first, with one retry when its process dies
    run_or_fail(["msm"], 1800, retry=True)
    # 2. the proof at the reference's default size
    if env.get("BENCH_SKIP_PROOF20"):
        skip(["proof20"], "BENCH_SKIP_PROOF20")
    elif remaining() < 1200:
        skip(["proof20"], "deadline")
    else:
        run_or_fail(["proof20"], 3600)
    # 3. the kernel legs, one process
    kernel_legs = [k for k in ("g2", "ntt")
                   if not env.get(f"BENCH_SKIP_{k.upper()}")]
    for k in ("g2", "ntt"):
        if k not in kernel_legs:
            detail[k] = {"skipped": f"BENCH_SKIP_{k.upper()}"}
    if kernel_legs:
        if remaining() < 300:
            skip(kernel_legs, "deadline")
        else:
            run_or_fail(kernel_legs, 2400)
    # 4. the proof from real keys (generated when not cached)
    if env.get("BENCH_SKIP_PROOF"):
        detail["proof"] = {"skipped": "BENCH_SKIP_PROOF"}
    elif not int(env.get("BENCH_PROOF_LOG2D", "16")):
        detail["proof"] = {"skipped": "BENCH_PROOF_LOG2D=0"}
    elif remaining() < 900:
        skip(["proof"], "deadline")
    else:
        run_or_fail(["proof"], 4800)
    emit()
    ran = [detail[k] for k in LEGS if "skipped" not in detail[k]]
    return 0 if all(r.get("correct") is True for r in ran) else 1


if __name__ == "__main__":
    sys.exit(main())
