"""MNT4753 proofs at the sizes users run, on one card, with the device
and host memory at every phase boundary.

    python3 prove_at_scale.py [LOG2 ...]          (default: 24 25)

LOG2 is log2(d + 1).  Each size runs in child processes of its own,
unforced (no resident_bytes, block_points or environment switch):

  2^20  the reference's GPU workflow at its default size, three children
        in one work directory: synthetic files and `gpu MNT4753
        preprocess` (the MNT4753_preprocessed table file, 24.96 GB);
        `gpu MNT4753 compute` beside that file (the table path); `gpu
        MNT4753 compute` in a directory without it (Pippenger).  Both
        proofs must equal the known logs and each other byte for byte.
        The children time the table build, its copy to the host and its
        write, and the tables' upload, where the prover has those steps
        as functions (models/preprocess_device.write_rows,
        models/gpu_prover.upload_tables), and print the prover's own
        lines and laps;
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
child that fails exits non-zero, and so does the parent.  The parent also
samples the used bytes of the work directory's file system and reports
each size's peak over its start (the table file and the key files).
"""

import contextlib
import hashlib
import io
import json
import os
import re
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


# -- the children -------------------------------------------------------------

class Child:
    """What every child does: a mark of the device and host memory at each
    phase boundary of the prover, and a host copy of H each time the
    prover computes it (the known logs of C are taken with the proof's
    own H)."""

    def __init__(self):
        import torch
        sys.path.insert(0, ROOT)
        from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
        self.torch, self.GP = torch, GP
        self.marks, self.h_std = [], []
        leave, compute_h = GP.leave_block, GP.compute_h

        def leave_and_mark(name):
            leave(name)
            self.mark(name)

        def keep_h(*args):
            out = compute_h(*args)
            self.h_std.append(out[1].cpu().numpy())
            return out
        GP.leave_block, GP.compute_h = leave_and_mark, keep_h
        torch.cuda.reset_peak_memory_stats()

    def mark(self, label: str) -> None:
        torch = self.torch
        m = dict(label=label, device_bytes=torch.cuda.memory_allocated(),
                 device_peak_bytes=torch.cuda.max_memory_allocated(),
                 host_rss_bytes=status_bytes("self", "VmRSS"),
                 host_peak_bytes=peak_rss_bytes())
        self.marks.append(m)
        print(f"[{label}] device {m['device_bytes'] / 2**30:.2f} GiB in "
              f"use, peak {m['device_peak_bytes'] / 2**30:.2f} GiB; host "
              f"RSS {m['host_rss_bytes'] / 2**30:.2f} GiB, peak "
              f"{m['host_peak_bytes'] / 2**30:.2f} GiB", flush=True)

    def finish(self, res: dict) -> int:
        """Print the child's JSON line; exit code 0 when res["ok"]."""
        res.update(peak_device_bytes=self.torch.cuda.max_memory_allocated(),
                   peak_host_bytes=peak_rss_bytes(), marks=self.marks)
        print(json.dumps(res), flush=True)
        return 0 if res["ok"] else 1


def child(log2: int, workdir: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("prove_at_scale: no CUDA card", file=sys.stderr)
        return 1
    ch = Child()
    GP = ch.GP
    from gpu_groth16_prover_3x_tpu_torch.curves.constants import MNT4753
    from gpu_groth16_prover_3x_tpu_torch.utils import profiling
    from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

    curve, dev = MNT4753, "cuda"
    rng = np.random.default_rng(SEED + log2)
    profiling.clear_laps()
    t0 = time.time()
    if log2 == 24:
        params, inp, ks, logs, values = SY.write_synthetic(curve, log2,
                                                           workdir, rng)
        files_s = time.time() - t0
        ch.mark("synthetic files written")
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
        ch.mark("params made in memory")
        t1 = time.time()
        sess = GP.ProverSession(curve, params, dev)
        stage_s = time.time() - t1
        del params
        ch.mark("params dropped")
        values = SY.input_values(curve, log2, rng)
        ch.mark("input made in memory")
        t1 = time.time()
        got = sess.prove(SY.input_arrays(values))
        torch.cuda.synchronize()
        wall = stage_s + time.time() - t1       # the session and the proof
        resident = sess.resident
        del sess
    want = SY.known_proof(curve, ks, logs, values[0], ch.h_std[0], values[4])
    ok = got == want
    print(f"MNT4753 2^{log2}: proof {wall:.2f} s (inputs made in "
          f"{files_s:.1f} s), A, B, C "
          f"{'equal' if ok else 'DIFFER FROM'} the known logs", flush=True)
    return ch.finish(dict(log2=log2, ok=ok, resident=resident, wall_s=wall,
                          inputs_s=files_s, laps=profiling.last_laps()))


TABLE_LOG2 = 20
TABLE_STEPS = ("preprocess", "compute", "pippenger")


def table_bytes(m: int) -> int:
    """Bytes of MNT4753_preprocessed for m variables: 31 multiples of B1
    and B2 (m + 1 points, 192 + 384 B) and of L (m - 1 points, 192 B)."""
    return 31 * ((m + 1) * 576 + (m - 1) * 192)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def timed_steps(torch, steps: dict, PD, GP):
    """Wrap the prover's table steps where it has them as functions (an
    older prover lacks some; they are then left out): the preprocess's
    load_params (host clock), models/preprocess_device.write_rows (one
    block of table rows to the file: its device-to-host copy and its
    write timed apart, after a synchronisation that leaves the block's
    build to the build) and models/gpu_prover.upload_tables (between two
    synchronisations).  Seconds are summed into `steps`: "load params",
    "copy", "write", "upload".  Returns an undo function."""
    saved = []

    def add(name, dt):
        steps[name] = steps.get(name, 0.0) + dt

    load_params = PD.load_params

    def timed_load(*args):
        t0 = time.perf_counter()
        out = load_params(*args)
        add("load params", time.perf_counter() - t0)
        return out
    saved.append((PD, "load_params", load_params))
    PD.load_params = timed_load
    if hasattr(PD, "write_rows"):
        write_rows = PD.write_rows

        def split(f, rows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = rows.cpu()
            t1 = time.perf_counter()
            write_rows(f, host)
            add("copy", t1 - t0)
            add("write", time.perf_counter() - t1)
        saved.append((PD, "write_rows", write_rows))
        PD.write_rows = split
    if hasattr(GP, "upload_tables"):
        upload = GP.upload_tables

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = upload(*args)
            torch.cuda.synchronize()
            add("upload", time.perf_counter() - t0)
            return out
        saved.append((GP, "upload_tables", upload))
        GP.upload_tables = timed

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def table_child(step: str, workdir: str) -> int:
    """One step of the 2^20 table workflow, run from the directory the
    parent chose: `preprocess` (files, then the table file beside them),
    `compute` (beside the table file) or `pippenger` (elsewhere)."""
    import torch
    if not torch.cuda.is_available():
        print("prove_at_scale: no CUDA card", file=sys.stderr)
        return 1
    ch = Child()
    GP = ch.GP
    from gpu_groth16_prover_3x_tpu_torch.curves.constants import MNT4753
    from gpu_groth16_prover_3x_tpu_torch.models import preprocess_device as PD
    from gpu_groth16_prover_3x_tpu_torch.ops import build
    from gpu_groth16_prover_3x_tpu_torch.utils import cli, profiling
    from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

    os.environ.pop("GROTH16_PREPROCESSED_PATH", None)
    curve, log2 = MNT4753, TABLE_LOG2
    d1 = 1 << log2
    params = os.path.join(workdir, f"{curve.name}-parameters")
    inp = os.path.join(workdir, f"{curve.name}-input")
    res, steps = dict(log2=log2, step=step), {}
    profiling.clear_laps()
    if step == "preprocess":
        t0 = time.time()
        SY.write_synthetic(curve, log2, workdir,
                           np.random.default_rng(SEED + log2))
        res["files_s"] = time.time() - t0
        ch.mark("synthetic files written")
    t0 = time.time()
    build.library()
    res["kernel_build_s"] = time.time() - t0
    undo = timed_steps(torch, steps, PD, GP)
    args = ([params] if step == "preprocess" else
            [params, inp, os.path.abspath("proof")])
    buf = io.StringIO()
    t1 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["gpu", curve.name, step.replace(
                "pippenger", "compute"), *args, "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        undo()
    res["wall_s"] = time.time() - t1
    text = buf.getvalue()
    print(text, end="", flush=True)
    res.update(rc=rc, steps=steps, laps=profiling.last_laps(),
               lines={k: float(v) for k, v in
                      re.findall(r"^(.+): ([0-9.]+)s$", text, re.M)})
    if step == "preprocess":
        size = os.path.getsize(f"{curve.name}_preprocessed")
        res.update(file_bytes=size, ok=rc == 0 and size == table_bytes(d1))
        ch.mark("table file written")
        print(f"MNT4753 2^{log2} preprocess: {res['wall_s']:.2f} s, "
              f"{size} bytes (expected {table_bytes(d1)}), steps {steps}",
              flush=True)
    else:
        inputs = GP.load_input(inp, curve, d1 - 1, d1)
        want = SY.known_proof(curve, SY.KS, SY.query_logs(log2),
                              inputs.w_mont.T, ch.h_std[0], inputs.r)
        tables = "load preprocessing" in res["lines"]
        res.update(sha256=sha256("proof"), tables=tables,
                   ok=(rc == 0 and tables == (step == "compute")
                       and SY.read_proof("proof", curve) == want))
        print(f"MNT4753 2^{log2} {step}: {res['wall_s']:.2f} s, table "
              f"path {tables}, A, B, C "
              f"{'equal' if res['ok'] else 'DIFFER FROM'} the known logs",
              flush=True)
    return ch.finish(res)


# -- the parent: children under a host-memory watch ------------------------------

def watch_child(args: list, cwd: str, disk_dir: str) -> dict:
    """Run `prove_at_scale.py --child *args` from `cwd` and watch it: its
    resident set (stopped past the cap) and the used bytes of the file
    system that holds disk_dir (peak_disk_used_bytes)."""
    cap = available_bytes() - HOST_MARGIN
    print(f"== {' '.join(args[:2])}: child started, host cap "
          f"{cap / 2**30:.1f} GiB (available less {HOST_MARGIN >> 30} GiB), "
          f"work directory {disk_dir}", flush=True)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=cwd)
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
    peak_disk = shutil.disk_usage(disk_dir).used
    while proc.poll() is None:
        try:
            rss = status_bytes(proc.pid, "VmRSS")
        except FileNotFoundError:
            break
        peak_rss = max(peak_rss, rss)
        peak_disk = max(peak_disk, shutil.disk_usage(disk_dir).used)
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
    res = {"ok": False}
    if lines and lines[-1].startswith("{"):
        res = json.loads(lines[-1])
    res.update(rc=proc.returncode, watched_peak_rss_bytes=peak_rss,
               last_phase=phase[0], peak_disk_used_bytes=peak_disk)
    if stopped:
        res["stopped"] = stopped
    elif proc.returncode:
        res["stopped"] = (f"exit {proc.returncode} in phase '{phase[0]}'")
    print(f"== {' '.join(args[:2])}: " + (
        f"STOPPED: {res['stopped']}" if "stopped" in res else "done")
          + f"; watched host RSS peak {peak_rss / 2**30:.2f} GiB",
          flush=True)
    return res


def run_child(log2: int) -> dict:
    work = tempfile.mkdtemp(prefix=f"scale{log2}-")
    try:
        base = shutil.disk_usage(work).used
        res = watch_child([str(log2), work], ROOT, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res.update(log2=log2, peak_disk_bytes=res["peak_disk_used_bytes"] - base)
    return res


def run_tables() -> list:
    """The 2^20 table workflow: preprocess, compute beside the file,
    compute without it; the two proofs must be byte-identical.  The
    table file is removed with the work directory whatever happens."""
    work = tempfile.mkdtemp(prefix=f"tables{TABLE_LOG2}-")
    pip = os.path.join(work, "pippenger")
    os.mkdir(pip)
    out = []
    try:
        base = shutil.disk_usage(work).used
        for step in TABLE_STEPS:
            res = watch_child([str(TABLE_LOG2), step, work],
                              pip if step == "pippenger" else work, work)
            res.update(log2=TABLE_LOG2, step=step, peak_disk_bytes=(
                res["peak_disk_used_bytes"] - base))
            out.append(res)
            if not res["ok"] or "stopped" in res:
                break
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if len(out) == len(TABLE_STEPS):
        same = out[1]["sha256"] == out[2]["sha256"]
        print(f"== 2^{TABLE_LOG2}: the table proof's sha256 "
              f"{'equals' if same else 'DIFFERS FROM'} the Pippenger "
              f"proof's", flush=True)
        if not same:
            out[1]["stopped"] = "sha256 differs from the Pippenger proof"
    return out


def main(argv) -> int:
    if len(argv) >= 1 and argv[0] == "--child":
        if len(argv) == 4:
            return table_child(argv[2], argv[3])
        return child(int(argv[1]), argv[2])
    sizes = [int(a) for a in argv] or [24, 25]
    for cmd in (["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], ["free", "-g"],
                ["df", "-h", tempfile.gettempdir(), ROOT]):
        print("$ " + " ".join(cmd), flush=True)
        print(subprocess.run(cmd, capture_output=True, text=True).stdout,
              flush=True)
    results = []
    for k in sizes:
        results += run_tables() if k == TABLE_LOG2 else [run_child(k)]
    print(json.dumps({"prove_at_scale": [
        {k: r.get(k) for k in (
            "log2", "step", "ok", "resident", "wall_s", "files_s",
            "kernel_build_s", "steps", "lines", "laps", "file_bytes",
            "sha256", "peak_device_bytes", "peak_host_bytes",
            "watched_peak_rss_bytes", "peak_disk_bytes", "stopped")}
        for r in results]}), flush=True)
    return 0 if results and all(r["ok"] and "stopped" not in r
                                for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
