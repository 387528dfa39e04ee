"""One MNT4753 proof at each size of the beyond-card path, on one card,
with the device and host memory at every phase boundary.

    python3 prove_at_scale.py [LOG2 ...]          (default: 24 25)

LOG2 is log2(d + 1).  Each size runs in a child process of its own,
unforced (no resident_bytes, block_points or environment switch):

  2^24  synthetic files (utils/synthetic.write_synthetic) through
        prove_files: the query rows stay on the card (chip_smoke.py
        phase 11a);
  2^25  a ProverSession on utils/synthetic.params_arrays, the params
        dropped once the session holds its rows, then the input made
        (utils/synthetic.input_values) and proved: the rows stay in host
        memory and go up a block at a time (chip_smoke.py phase 11d).

The parent prints the card's name and power limit, `free -g` and `df -h`
of the work directory, and watches each child's resident set: a child
whose resident set passes HOST_MARGIN below the host's available memory
is stopped, and the parent names the phase it was in, so the host is
never driven into swapping or its out-of-memory killer.  The child prints
at each phase boundary of the prover the device memory in use and its
peak (torch.cuda) and the host's resident set and its peak (VmRSS of
/proc/self/status, getrusage's ru_maxrss); then its laps, and whether A,
B and C equal the known logs, with H taken from the proof's own pipeline
(utils/synthetic.known_proof).  Its last line is one JSON object; a
child that fails exits non-zero, and so does the parent.
"""

import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HOST_MARGIN = 6 << 30       # bytes of available host memory left unused
CHILD_TIMEOUT = 1500        # seconds a child may take
SEED = 20261017


def status_bytes(pid, key: str) -> int:
    """A /proc/<pid>/status memory line (VmRSS) in bytes."""
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    return 0


def peak_rss_bytes() -> int:
    """This process's peak resident set (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


# -- the child: one proof -------------------------------------------------------

def child(log2: int, workdir: str) -> int:
    import torch
    sys.path.insert(0, ROOT)
    from gpu_groth16_prover_3x_tpu_torch.curves.constants import MNT4753
    from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
    from gpu_groth16_prover_3x_tpu_torch.utils import profiling
    from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

    if not torch.cuda.is_available():
        print("prove_at_scale: no CUDA card", file=sys.stderr)
        return 1
    curve, dev = MNT4753, "cuda"
    rng = np.random.default_rng(SEED + log2)
    marks = []

    def mark(label: str) -> None:
        m = dict(label=label, device_bytes=torch.cuda.memory_allocated(),
                 device_peak_bytes=torch.cuda.max_memory_allocated(),
                 host_rss_bytes=status_bytes("self", "VmRSS"),
                 host_peak_bytes=peak_rss_bytes())
        marks.append(m)
        print(f"[{label}] device {m['device_bytes'] / 2**30:.2f} GiB in "
              f"use, peak {m['device_peak_bytes'] / 2**30:.2f} GiB; host "
              f"RSS {m['host_rss_bytes'] / 2**30:.2f} GiB, peak "
              f"{m['host_peak_bytes'] / 2**30:.2f} GiB", flush=True)

    leave = GP.leave_block

    def leave_and_mark(name):
        leave(name)
        mark(name)
    GP.leave_block = leave_and_mark
    h_std = []
    compute_h = GP.compute_h

    def keep_h(*args):
        out = compute_h(*args)
        h_std.append(out[1].cpu().numpy())
        return out
    GP.compute_h = keep_h

    torch.cuda.reset_peak_memory_stats()
    profiling.clear_laps()
    t0 = time.time()
    if log2 == 24:
        params, inp, ks, logs, values = SY.write_synthetic(curve, log2,
                                                           workdir, rng)
        files_s = time.time() - t0
        mark("synthetic files written")
        out = os.path.join(workdir, "proof")
        t1 = time.time()
        GP.prove_files(curve, params, inp, out, device=dev)
        wall = time.time() - t1
        got = SY.read_proof(out, curve)
        resident = None
    else:
        params = SY.params_arrays(curve, log2)
        ks, logs = SY.KS, SY.query_logs(log2)
        files_s = time.time() - t0
        mark("params made in memory")
        t1 = time.time()
        sess = GP.ProverSession(curve, params, dev)
        stage_s = time.time() - t1
        del params
        mark("params dropped")
        values = SY.input_values(curve, log2, rng)
        mark("input made in memory")
        t1 = time.time()
        got = sess.prove(SY.input_arrays(values))
        torch.cuda.synchronize()
        wall = stage_s + time.time() - t1       # the session and the proof
        resident = sess.resident
        del sess
    want = SY.known_proof(curve, ks, logs, values[0], h_std[0], values[4])
    ok = got == want
    print(f"MNT4753 2^{log2}: proof {wall:.2f} s (inputs made in "
          f"{files_s:.1f} s), A, B, C "
          f"{'equal' if ok else 'DIFFER FROM'} the known logs", flush=True)
    print(json.dumps(dict(
        log2=log2, ok=ok, resident=resident, wall_s=wall, inputs_s=files_s,
        laps=profiling.last_laps(),
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        peak_host_bytes=peak_rss_bytes(), marks=marks)),
        flush=True)
    return 0 if ok else 1


# -- the parent: children under a host-memory watch ------------------------------

def run_child(log2: int) -> dict:
    work = tempfile.mkdtemp(prefix=f"scale{log2}-")
    cap = available_bytes() - HOST_MARGIN
    print(f"== 2^{log2}: child started, host cap {cap / 2**30:.1f} GiB "
          f"(available less {HOST_MARGIN >> 30} GiB), work directory "
          f"{work}", flush=True)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(log2),
         work], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT)
    lines, phase = [], ["start"]

    def pump():
        for line in proc.stdout:
            print(line, end="", flush=True)
            lines.append(line)
            if "(enter)" in line:
                phase[0] = line.split("(enter)", 1)[1].strip()
    reader = threading.Thread(target=pump)
    reader.start()
    stopped, peak_rss, t0 = None, 0, time.time()
    while proc.poll() is None:
        try:
            rss = status_bytes(proc.pid, "VmRSS")
        except FileNotFoundError:
            break
        peak_rss = max(peak_rss, rss)
        if rss > cap:
            stopped = (f"host RSS {rss / 2**30:.1f} GiB past the cap of "
                       f"{cap / 2**30:.1f} GiB in phase '{phase[0]}'")
            proc.kill()
        elif time.time() - t0 > CHILD_TIMEOUT:
            stopped = f"over {CHILD_TIMEOUT} s in phase '{phase[0]}'"
            proc.kill()
        time.sleep(0.05)
    proc.wait()
    reader.join(timeout=60)
    shutil.rmtree(work, ignore_errors=True)
    res = {"log2": log2, "ok": False}
    if lines and lines[-1].startswith("{"):
        res = json.loads(lines[-1])
    res.update(rc=proc.returncode, watched_peak_rss_bytes=peak_rss,
               last_phase=phase[0])
    if stopped:
        res["stopped"] = stopped
    elif proc.returncode:
        res["stopped"] = (f"exit {proc.returncode} in phase '{phase[0]}'")
    print(f"== 2^{log2}: " + (f"STOPPED: {res['stopped']}" if "stopped" in
                             res else "done")
          + f"; watched host RSS peak {peak_rss / 2**30:.2f} GiB",
          flush=True)
    return res


def main(argv) -> int:
    if len(argv) >= 1 and argv[0] == "--child":
        return child(int(argv[1]), argv[2])
    sizes = [int(a) for a in argv] or [24, 25]
    for cmd in (["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], ["free", "-g"],
                ["df", "-h", tempfile.gettempdir(), ROOT]):
        print("$ " + " ".join(cmd), flush=True)
        print(subprocess.run(cmd, capture_output=True, text=True).stdout,
              flush=True)
    results = [run_child(k) for k in sizes]
    print(json.dumps({"prove_at_scale": [
        {k: r.get(k) for k in ("log2", "ok", "resident", "wall_s", "laps",
                               "peak_device_bytes", "peak_host_bytes",
                               "watched_peak_rss_bytes", "stopped")}
        for r in results]}), flush=True)
    return 0 if all(r["ok"] and "stopped" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
