"""Proofs at the sizes users run, on one card, with the device and host
memory at every phase boundary.

    python3 prove_at_scale.py [LOG2 | wD-LOG2 | keys | oracle-15 ...]
                                                     (default: 24 25)

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

keys and oracle-15 (KEY_RUNS) drive real keys at the reference's
default sizes (generate_all: MNT4753 2^20, MNT6753 2^15), a child a
step, in one work directory:

  keys       setup: generate_parameters on the card at SEED with its
             trapdoor, the laps, the identity rows of each query (A, B1
             and B2 must hold some); pippenger: `gpu compute` unforced,
             checked by verify_with_trapdoor, then with the rows in host
             memory in blocks of 2^(log2 - 1) points and through `serve`
             (twice), each sha256-equal to the unforced proof; preprocess:
             the table files, table_bytes long; compute: beside them, the
             table path, sha256-equal to the Pippenger proof;
  oracle-15  MNT6753 alone: setup and pippenger as above, then `cpu
             compute`, the reference's oracle, sha256-equal to the gpu
             proof.

The steps are functions of (work directory, sizes, device); the CPU tests
run them at 2^4 (tests/test_torch_real_keys.py).

wD-LOG2 (SHARDED: w1-24, w1-25, w2-24) is parallel/prover.prove_sharded
over D ranks that the child spawns (parallel/multihost.launch_local; nccl
at world 1, gloo for two ranks on one card, which nccl refuses), each
rank loading the whole key as the README's recipe does: at 2^24 from
synthetic files the child writes, at 2^25 made in memory in the rank
(params_arrays, input_values).  Each rank prints its device memory in
use and peak, the card's used memory and the host RSS of the child's
process tree at each phase boundary, then its laps, collectives (calls,
seconds, bytes sent), uploads of host rows, launches, bucket-scan
launches per group configuration against the block grid's count, and
whether A, B and C equal the known logs (H's log summed over the ranks'
domain slices).  Every rank must return the same proof.

The parent prints the card's name and power limit, `free -g` and `df -h`
of the work directory, and watches each child's process tree (the child
and the ranks it spawns): a tree whose summed resident set passes
HOST_MARGIN below the host's available memory is stopped, and the parent
names the phase it was in, so the host is never driven into swapping or
its out-of-memory killer.  The parent also samples the card's used
memory (nvidia-smi), which with two ranks on the card is more than either
rank's peak.  The child prints at each phase boundary of the prover the
device memory in use and its peak (torch.cuda), the card's used memory,
the host's resident set and its peak (VmRSS of /proc/self/status,
getrusage's ru_maxrss) and its process tree's; then its laps, and whether A,
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
import signal
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
# name: (ranks, log2(d + 1), backend, keys from files (else in memory))
SHARDED = {"w1-24": (1, 24, "nccl", True),
           "w1-25": (1, 25, "nccl", False),
           "w2-24": (2, 24, "gloo", True)}


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


def tree_pids(root: int) -> list:
    """root and every process descended from it, by the parent pid of
    each /proc/<pid>/stat (the ranks that launch_local spawns are the
    child's children, the watcher's grandchildren)."""
    children = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue        # ended while we read
        children.setdefault(ppid, []).append(int(name))
    out, todo = [], [root]
    while todo:
        pid = todo.pop()
        out.append(pid)
        todo += children.get(pid, [])
    return out


def tree_rss_bytes(root: int) -> int:
    """The summed resident set of root's process tree."""
    total = 0
    for pid in tree_pids(root):
        try:
            total += status_bytes(pid, "VmRSS")
        except OSError:
            pass
    return total


def kill_tree(root: int) -> None:
    """SIGKILL root and every process descended from it."""
    for pid in tree_pids(root):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def card_used_bytes():
    """The card's used memory as nvidia-smi reads it (every process on
    it, CUDA contexts included), or None where it does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=10).stdout
        return int(out.split()[0]) << 20
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


# -- the children -------------------------------------------------------------

class Child:
    """What every child (and every rank of a sharded run) does: a mark of
    the device and host memory at each phase boundary of the prover
    (models/gpu_prover's blocks, whose ProverSession every rank runs), and
    a host copy of H each time it computes it (the known logs of C are
    taken with the proof's own H).  A mark's host figures are this
    process's and those of tree_root's process tree."""

    def __init__(self, tree_root=None, prefix: str = ""):
        import torch
        sys.path.insert(0, ROOT)
        from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
        self.torch, self.GP = torch, GP
        self.tree_root, self.prefix = tree_root or os.getpid(), prefix
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
        free, total = torch.cuda.mem_get_info()
        m = dict(label=label, device_bytes=torch.cuda.memory_allocated(),
                 device_peak_bytes=torch.cuda.max_memory_allocated(),
                 card_used_bytes=total - free,
                 host_rss_bytes=status_bytes("self", "VmRSS"),
                 host_peak_bytes=peak_rss_bytes(),
                 tree_rss_bytes=tree_rss_bytes(self.tree_root))
        self.marks.append(m)
        print(f"{self.prefix}[{label}] device {m['device_bytes'] / 2**30:.2f}"
              f" GiB in use, peak {m['device_peak_bytes'] / 2**30:.2f} GiB, "
              f"card used {m['card_used_bytes'] / 2**30:.2f} GiB; host RSS "
              f"{m['host_rss_bytes'] / 2**30:.2f} GiB, peak "
              f"{m['host_peak_bytes'] / 2**30:.2f} GiB, process tree "
              f"{m['tree_rss_bytes'] / 2**30:.2f} GiB", flush=True)

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


def table_bytes(curve, m: int) -> int:
    """Bytes of <CURVE>_preprocessed for m variables: 31 multiples of B1
    and B2 (m + 1 points; an affine G1 point is 192 B, a G2 point 384 B
    over MNT4753's Fq2 and 576 B over MNT6753's Fq3) and of L (m - 1
    points, 192 B)."""
    g1, g2 = 2 * 96, 2 * curve.ext_degree * 96
    return 31 * ((m + 1) * (g1 + g2) + (m - 1) * g1)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def timed_steps(steps: dict, PD, GP, device="cuda"):
    """Wrap the prover's table steps where it has them as functions (an
    older prover lacks some; they are then left out): the preprocess's
    load_params (host clock), models/preprocess_device.write_rows (one
    block of table rows to the file: its device-to-host copy and its
    write timed apart, after a synchronisation that leaves the block's
    build to the build) and models/gpu_prover.upload_tables (between two
    synchronisations).  Seconds are summed into `steps`: "load params",
    "copy", "write", "upload".  Returns an undo function."""
    import torch
    dev = torch.device(device)
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
            GP.sync_device(dev)
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
            GP.sync_device(dev)
            t0 = time.perf_counter()
            out = upload(*args)
            GP.sync_device(dev)
            add("upload", time.perf_counter() - t0)
            return out
        saved.append((GP, "upload_tables", upload))
        GP.upload_tables = timed

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def launch_counters() -> dict:
    """The launch counter of each kernel wrapper."""
    from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK
    from gpu_groth16_prover_3x_tpu_torch.ops import mont_mul as MM
    from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
    from gpu_groth16_prover_3x_tpu_torch.ops import ntt as NT
    return {"mont_mul": MM.MONT_MUL, "ec_add": GK.EC_ADD,
            "ec_dbl": GK.EC_DBL, "ec_mixed_add": GK.EC_MIXED_ADD,
            "msm_scan": M.MSM_SCAN, "ntt_addsub": NT.NTT_ADDSUB}


def start_run(dev) -> None:
    """Just before a run: each kernel's launches from 0, no block laps,
    the device's peak memory from here."""
    import torch
    from gpu_groth16_prover_3x_tpu_torch.utils import profiling
    for k in launch_counters().values():
        k.launches = 0
    profiling.clear_laps()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def end_run(dev) -> dict:
    """Just after a run, the card drained: its launches, block laps and
    peak device memory (None on the CPU)."""
    import torch
    from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
    from gpu_groth16_prover_3x_tpu_torch.utils import profiling
    GP.sync_device(dev)
    return dict(launches={n: k.launches for n, k in
                          launch_counters().items()},
                laps=profiling.last_laps(),
                peak_device_bytes=(torch.cuda.max_memory_allocated()
                                   if dev.type == "cuda" else None))


def cli_run(argv: list, device: str) -> dict:
    """One command of the port's CLI (utils/cli.main) with its standard
    output captured and echoed: exit code, seconds to a drained card, the
    run's launches, laps and device peak (start_run, end_run), the
    `<label>: <seconds>s` lines it printed and its table steps
    (timed_steps)."""
    import torch
    from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
    from gpu_groth16_prover_3x_tpu_torch.models import preprocess_device as PD
    from gpu_groth16_prover_3x_tpu_torch.utils import cli
    dev = torch.device(device)
    steps = {}
    start_run(dev)
    undo = timed_steps(steps, PD, GP, device)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        res = end_run(dev)
    finally:
        undo()
    res.update(rc=rc, wall_s=time.perf_counter() - t0, steps=steps)
    text = buf.getvalue()
    print(text, end="", flush=True)
    res["lines"] = {k: float(v) for k, v in
                    re.findall(r"^(.+): ([0-9.]+)s$", text, re.M)}
    return res


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
    from gpu_groth16_prover_3x_tpu_torch.ops import build
    from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

    os.environ.pop("GROTH16_PREPROCESSED_PATH", None)
    curve, log2 = MNT4753, TABLE_LOG2
    d1 = 1 << log2
    params = os.path.join(workdir, f"{curve.name}-parameters")
    inp = os.path.join(workdir, f"{curve.name}-input")
    res = dict(log2=log2, step=step)
    if step == "preprocess":
        t0 = time.time()
        SY.write_synthetic(curve, log2, workdir,
                           np.random.default_rng(SEED + log2))
        res["files_s"] = time.time() - t0
        ch.mark("synthetic files written")
    t0 = time.time()
    build.library()
    res["kernel_build_s"] = time.time() - t0
    args = ([params] if step == "preprocess" else
            [params, inp, os.path.abspath("proof")])
    res.update(cli_run(["gpu", curve.name, step.replace(
        "pippenger", "compute"), *args, "--device", "cuda"], "cuda"))
    rc, steps = res["rc"], res["steps"]
    if step == "preprocess":
        size = os.path.getsize(f"{curve.name}_preprocessed")
        want = table_bytes(curve, d1)
        res.update(file_bytes=size, ok=rc == 0 and size == want)
        ch.mark("table file written")
        print(f"MNT4753 2^{log2} preprocess: {res['wall_s']:.2f} s, "
              f"{size} bytes (expected {want}), steps {steps}", flush=True)
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


# -- real keys: generate_parameters at its default sizes, every proving path --

# generate_all's default sizes (models/setup.py), log2(d + 1) per curve
KEY_SIZES = {"MNT4753": 20, "MNT6753": 15}
SETUP_LAPS = ("setup host part (R1CS, QAP, scalar vectors)",
              "batch_exp A (device)", "batch_exp B1 (device)",
              "batch_exp B2 (device)", "batch_exp L (device)",
              "batch_exp H (device)", "write files", "write trapdoor")
QUERIES = ("A", "B1", "B2", "L", "H")
# the kernels a command must launch on a card
SETUP_KERNELS = ("mont_mul", "ec_add", "ec_mixed_add")
PATH_KERNELS = ("mont_mul", "ec_add", "ec_dbl", "msm_scan", "ntt_addsub")
BUILD_KERNELS = ("mont_mul", "ec_mixed_add")
PIPPENGER_DIR = "pippenger"     # holds no table file
# the environment that could switch a proof off the path a step drives
PATH_VARS = ("GROTH16_PREPROCESSED_PATH", "GROTH16_MSM_RESIDENT_BYTES",
             "GROTH16_MSM_BLOCK_POINTS")


def key_paths(workdir: str, name: str) -> tuple:
    """(parameters, input, trapdoor JSON) of a curve's keys in workdir."""
    return tuple(os.path.join(workdir, f"{name}-{k}")
                 for k in ("parameters", "input", "trapdoor.json"))


def pippenger_proof(workdir: str, name: str) -> str:
    """The unforced Pippenger proof, which the other paths must equal."""
    return os.path.join(workdir, PIPPENGER_DIR, f"{name}-proof")


def identity_rows(params_path: str, curve) -> dict:
    """Per query, its all-zero rows: the point at infinity (y == 0)."""
    from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
    p = GP.load_params(params_path, curve)
    return {q: int((~getattr(p, q).any(1)).sum()) for q in QUERIES}


def unlaunched(what: str, run: dict, names, dev) -> list:
    """The faults of a run on a card in which a kernel of `names` never
    launched (the CPU runs the plain versions, which launch nothing)."""
    missing = [n for n in names if not run["launches"][n]]
    return [f"{what}: never launched {missing}"] \
        if dev.type == "cuda" and missing else []


@contextlib.contextmanager
def environment(**values):
    """The process environment with `values` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class StreamedBlocks:
    """The streamed MSMs of models/gpu_prover (msm_window_sums_streamed):
    per call its group configuration, where its rows lay, its block grid,
    and each block that holds an identity row with a point after it in
    the block (so not the grid's zero padding): [block, such rows]."""

    def __enter__(self):
        import torch
        from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
        from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
        self.GP, self.saved, self.calls = GP, GP.msm_window_sums_streamed, []

        def keep(cops, keys, rows, chunk_s, c, seg, num, block, *args):
            nblk, per = M.block_grid(rows.shape[0], chunk_s, block)
            live = torch.as_tensor(rows).ne(0).any(1).cpu()
            inner = []
            for i in range(nblk):
                pts = torch.nonzero(live[i * per:(i + 1) * per]).flatten()
                if len(pts):
                    k = int(pts[-1]) + 1 - len(pts)
                    if k:
                        inner.append([i, k])
            self.calls.append(dict(
                cfg=cops.cfg, deg=cops.deg, rows=rows.shape[0],
                rows_on="device" if torch.is_tensor(rows)
                and rows.device.type != "cpu" else "host",
                blocks=nblk, block_points=per, identity_blocks=inner))
            return self.saved(cops, keys, rows, chunk_s, c, seg, num, block,
                              *args)
        GP.msm_window_sums_streamed = keep
        return self

    def __exit__(self, *exc):
        self.GP.msm_window_sums_streamed = self.saved


def block_faults(calls: list, uploads) -> list:
    """What the host-row proof breaks: its two streamed MSMs (G1, then
    B2) each from host rows in more than one block, with an identity row
    inside a block (StreamedBlocks), and on a card (uploads: UploadTimer's
    totals and strays) one upload a block, each from pinned memory on the
    copy stream."""
    out = [] if [k["deg"] > 1 for k in calls] == [False, True] else \
        [f"streamed MSMs of degrees {[k['deg'] for k in calls]}, not G1 "
         f"and B2"]
    for k in calls:
        if k["rows_on"] != "host" or k["blocks"] < 2 or \
                not k["identity_blocks"]:
            out.append(f"cfg {k['cfg']}: rows on the {k['rows_on']} in "
                       f"{k['blocks']} blocks, identity rows inside blocks "
                       f"{k['identity_blocks']}")
    if uploads is not None:
        (n, _, _), stray = uploads
        if n != sum(k["blocks"] for k in calls) or stray:
            out.append(f"{n} uploads ({stray} not pinned or not on the copy "
                       f"stream) for {sum(k['blocks'] for k in calls)} "
                       f"blocks")
    return out


def setup_step(workdir: str, sizes: dict, device: str) -> dict:
    """generate_parameters for each curve of `sizes` (name -> log2(d + 1))
    at SEED, with its trapdoor, into workdir, with no checkpoint
    ($GROTH16_SETUP_CACHE) to stand in for it.  The keys must hold
    identity rows in A, B1 and B2 (the y == 0 path the proofs then take);
    on a card the setup must launch SETUP_KERNELS."""
    import torch
    from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
    from gpu_groth16_prover_3x_tpu_torch.models import setup as SU
    os.environ.pop("GROTH16_SETUP_CACHE", None)
    dev = torch.device(device)
    curves, faults = {}, []
    for name, log2 in sizes.items():
        params, inp, td = key_paths(workdir, name)
        start_run(dev)
        t0 = time.perf_counter()
        SU.generate_parameters(CURVES[name], log2, params, inp, seed=SEED,
                               trapdoor_path=td, device=device)
        res = end_run(dev)
        res.update(log2=log2, wall_s=time.perf_counter() - t0,
                   laps={k: v for k, v in res["laps"].items()
                         if k in SETUP_LAPS},
                   identity_rows=identity_rows(params, CURVES[name]),
                   bytes={k: os.path.getsize(p) for k, p in
                          zip(("parameters", "input", "trapdoor"),
                              (params, inp, td))})
        curves[name] = res
        none = [q for q in ("A", "B1", "B2") if not res["identity_rows"][q]]
        if none:
            faults.append(f"{name}: no identity row in {none}")
        faults += unlaunched(f"{name} setup", res, SETUP_KERNELS, dev)
        print(f"{name} 2^{log2} generate_parameters: {res['wall_s']:.2f} s,"
              f" peak device {(res['peak_device_bytes'] or 0) / 2**30:.2f} "
              f"GiB, launches {res['launches']}; identity rows "
              f"{res['identity_rows']}; bytes {res['bytes']}", flush=True)
        for k, v in res["laps"].items():
            print(f"  {k}: {v:.3f} s", flush=True)
    return dict(step="setup", ok=not faults, faults=faults, curves=curves)


def pippenger_step(workdir: str, sizes: dict, device: str) -> dict:
    """Each curve's keys proved by Pippenger in workdir/pippenger (no
    table file there): `gpu compute` unforced, its proof held against
    host/groth16.verify_with_trapdoor; then the same files with the rows
    kept in host memory in blocks of 2^(log2 - 1) points (the G1 rows in
    8 blocks, B2 in 3; on a card uploaded block by block), and `serve`
    of the input twice: each proof's sha256 must equal the unforced
    one's."""
    import torch
    from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
    from gpu_groth16_prover_3x_tpu_torch.host import groth16 as HG
    from gpu_groth16_prover_3x_tpu_torch.models import setup as SU
    from gpu_groth16_prover_3x_tpu_torch.utils.synthetic import read_proof
    dev = torch.device(device)
    for var in PATH_VARS:
        os.environ.pop(var, None)
    pip = os.path.join(workdir, PIPPENGER_DIR)
    os.makedirs(pip, exist_ok=True)
    curves, faults = {}, []
    with contextlib.chdir(pip):
        for name, log2 in sizes.items():
            curve = CURVES[name]
            params, inp, td = key_paths(workdir, name)
            out = {k: os.path.join(pip, f"{name}-{k}")
                   for k in ("host-rows", "serve-0", "serve-1")}
            out["unforced"] = pippenger_proof(workdir, name)
            gpu = ["gpu", name]
            runs = {"unforced": cli_run(gpu + [
                "compute", params, inp, out["unforced"], "--device", device],
                device)}
            t0 = time.perf_counter()
            verified = HG.verify_with_trapdoor(
                curve, SU.trapdoor_result(curve, td, inp),
                *read_proof(out["unforced"], curve))
            verify_s = time.perf_counter() - t0
            block = 1 << (log2 - 1)
            timer = UploadTimer() if dev.type == "cuda" else \
                contextlib.nullcontext()
            with environment(GROTH16_MSM_RESIDENT_BYTES="0",
                             GROTH16_MSM_BLOCK_POINTS=str(block)), \
                    StreamedBlocks() as blocks, timer as up:
                runs["host rows"] = cli_run(gpu + [
                    "compute", params, inp, out["host-rows"], "--device",
                    device], device)
            uploads = None if up is None else (up.totals(), up.stray)
            runs["serve"] = cli_run(gpu + [
                "serve", params, inp, out["serve-0"], inp, out["serve-1"],
                "--device", device], device)
            shas = {k: sha256(p) for k, p in out.items()}
            bad = [k for k, v in shas.items() if v != shas["unforced"]]
            for k, r in runs.items():
                if r["rc"]:
                    faults.append(f"{name} {k}: exit {r['rc']}")
                faults += unlaunched(f"{name} {k}", r, PATH_KERNELS, dev)
            if not verified:
                faults.append(f"{name}: the proof fails verify_with_trapdoor")
            if bad:
                faults.append(f"{name}: {bad} differ from the unforced proof")
            faults += [f"{name} host rows: {f}"
                       for f in block_faults(blocks.calls, uploads)]
            curves[name] = dict(log2=log2, runs=runs, verified=verified,
                                verify_s=verify_s, sha256=shas,
                                block_points=block, streamed=blocks.calls,
                                uploads=uploads)
            print(f"{name} 2^{log2} Pippenger: unforced "
                  f"{runs['unforced']['wall_s']:.2f} s, verify_with_trapdoor "
                  f"{verified} ({verify_s:.1f} s); host rows in blocks of "
                  f"{block} {runs['host rows']['wall_s']:.2f} s, streamed "
                  f"{blocks.calls}, uploads {uploads}; serve x 2 "
                  f"{runs['serve']['wall_s']:.2f} s; sha256 "
                  f"{shas['unforced']}, {'all equal' if not bad else bad}",
                  flush=True)
    return dict(step="pippenger", ok=not faults, faults=faults,
                curves=curves)


def preprocess_step(workdir: str, sizes: dict, device: str) -> dict:
    """`gpu <CURVE> preprocess` on each curve's keys in workdir: its table
    file beside them, table_bytes(curve, m) long, built on BUILD_KERNELS
    on a card."""
    import torch
    from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
    dev = torch.device(device)
    os.environ.pop("GROTH16_PREPROCESSED_PATH", None)
    curves, faults = {}, []
    with contextlib.chdir(workdir):
        for name, log2 in sizes.items():
            params, _, _ = key_paths(workdir, name)
            res = cli_run(["gpu", name, "preprocess", params, "--device",
                           device], device)
            want = table_bytes(CURVES[name], 1 << log2)
            res.update(log2=log2, file_bytes=os.path.getsize(
                f"{name}_preprocessed"), want_bytes=want)
            curves[name] = res
            if res["rc"] or res["file_bytes"] != want:
                faults.append(f"{name}: exit {res['rc']}, "
                              f"{res['file_bytes']} bytes, not {want}")
            faults += unlaunched(f"{name} preprocess", res, BUILD_KERNELS,
                                 dev)
            print(f"{name} 2^{log2} preprocess: {res['wall_s']:.2f} s, "
                  f"{res['file_bytes']} bytes (expected {want}), steps "
                  f"{res['steps']}, launches {res['launches']}", flush=True)
    return dict(step="preprocess", ok=not faults, faults=faults,
                curves=curves)


def compute_step(workdir: str, sizes: dict, device: str) -> dict:
    """`gpu <CURVE> compute` in workdir, beside each curve's table file:
    it must load the file (the table path) and write the bytes of the
    Pippenger proof."""
    import torch
    dev = torch.device(device)
    for var in PATH_VARS:
        os.environ.pop(var, None)
    curves, faults = {}, []
    with contextlib.chdir(workdir):
        for name, log2 in sizes.items():
            params, inp, _ = key_paths(workdir, name)
            out = os.path.join(workdir, f"{name}-table-proof")
            res = cli_run(["gpu", name, "compute", params, inp, out,
                           "--device", device], device)
            res.update(log2=log2, tables="load preprocessing" in
                       res["lines"], sha256=sha256(out))
            curves[name] = res
            same = res["sha256"] == sha256(pippenger_proof(workdir, name))
            if res["rc"] or not res["tables"] or not same:
                faults.append(f"{name}: exit {res['rc']}, table path "
                              f"{res['tables']}, sha256 "
                              f"{'equal' if same else 'DIFFERENT'}")
            faults += unlaunched(f"{name} table proof", res, PATH_KERNELS,
                                 dev)
            print(f"{name} 2^{log2} compute beside the table file: "
                  f"{res['wall_s']:.2f} s, table path {res['tables']}, "
                  f"sha256 {res['sha256']} "
                  f"{'equals' if same else 'DIFFERS FROM'} the Pippenger "
                  f"proof's; launches {res['launches']}", flush=True)
    return dict(step="compute", ok=not faults, faults=faults, curves=curves)


def oracle_step(workdir: str, sizes: dict, device: str) -> dict:
    """`cpu <CURVE> compute`, the host oracle (native C++ MSMs), on each
    curve's keys: its proof must have the Pippenger proof's sha256."""
    curves, faults = {}, []
    for name, log2 in sizes.items():
        params, inp, _ = key_paths(workdir, name)
        out = os.path.join(workdir, f"{name}-oracle-proof")
        res = cli_run(["cpu", name, "compute", params, inp, out], device)
        res.update(log2=log2, sha256=sha256(out))
        curves[name] = res
        same = res["sha256"] == sha256(pippenger_proof(workdir, name))
        if res["rc"] or not same:
            faults.append(f"{name}: exit {res['rc']}, the oracle's sha256 "
                          f"{'equals' if same else 'DIFFERS FROM'} the gpu "
                          f"proof's")
        print(f"{name} 2^{log2} cpu compute (the oracle): "
              f"{res['wall_s']:.2f} s, sha256 {res['sha256']} "
              f"{'equals' if same else 'DIFFERS FROM'} the gpu proof's",
              flush=True)
    return dict(step="oracle", ok=not faults, faults=faults, curves=curves)


KEY_STEPS = {"setup": setup_step, "pippenger": pippenger_step,
             "preprocess": preprocess_step, "compute": compute_step,
             "oracle": oracle_step}
# run: (curves, steps in order)
KEY_RUNS = {"keys": (("MNT4753", "MNT6753"),
                     ("setup", "pippenger", "preprocess", "compute")),
            "oracle-15": (("MNT6753",), ("setup", "pippenger", "oracle"))}


def key_child(run: str, step: str, workdir: str) -> int:
    """One step of a KEY_RUNS run on the card, at KEY_SIZES."""
    import torch
    if not torch.cuda.is_available():
        print("prove_at_scale: no CUDA card", file=sys.stderr)
        return 1
    ch = Child()
    from gpu_groth16_prover_3x_tpu_torch.ops import build
    from gpu_groth16_prover_3x_tpu_torch.utils import native
    t0 = time.time()
    build.library()
    native.available()
    build_s = time.time() - t0
    names, _ = KEY_RUNS[run]
    res = KEY_STEPS[step](workdir, {n: KEY_SIZES[n] for n in names}, "cuda")
    res.update(run=run, kernel_build_s=build_s)
    print(f"{run} {step}: {'ok' if res['ok'] else 'FAILED'}; faults "
          f"{res['faults'] or 'none'}", flush=True)
    return ch.finish(res)


# -- sharded runs: ranks spawned by the child ------------------------------

def scans_per_pass(points: int, chunk: int, c: int) -> int:
    """Bucket-scan launches of one msm_window_sums pass over `points`
    points: 768 / c windows, as many a launch as ops/msm.py fits."""
    from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
    nwin = 768 // c
    wb = M._fit_block(nwin, min(max(1, M.SCAN_LANES // (points // chunk)),
                                max(1, M.SCAN_POINTS // points)))
    return nwin // wb


def rank_grid(log2: int, world: int, rank: int) -> dict:
    """The block grid an unforced rank streams each MSM over, worked out
    from the sizes alone: per group configuration (0 G1, 1 B2), (rows,
    blocks, points a block, scan launches), blocks of STREAM_BLOCK
    (ops/msm.block_grid) on the rank's rows rounded to its chunk."""
    import torch
    from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
    from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
    d1 = 1 << log2
    d, m = d1 - 1, d1
    wl = -(-(m + 1) // world)
    lo, hi = min(rank * wl, m + 1), min((rank + 1) * wl, m + 1)
    nl = d1 // world
    hlo = rank * nl
    n_l = max(hi, GP.PI1) - max(lo, GP.PI1)
    n_g1 = 2 * (hi - lo) + n_l + min(hlo + nl, d) - hlo
    chunk, c, _ = GP.resolve_msm_cfg(wl, torch.device("cuda"))
    if GP.round_up(n_g1, chunk) <= GP.STREAM_ABOVE:
        raise ValueError(f"2^{log2} over {world} ranks is not streamed")
    out = {}
    for cfg, n in ((0, n_g1), (1, hi - lo)):
        nblk, per = M.block_grid(GP.round_up(n, chunk), chunk,
                                 GP.STREAM_BLOCK)
        out[cfg] = (n, nblk, per, nblk * scans_per_pass(per, chunk, c))
    return out


class KernelTimer:
    """CUDA events around calls of kernel wrappers, summed per label and
    group configuration.  `targets` maps a label to (module, attribute):
    the callers look the wrapper up as that module's attribute at each
    call (ops/msm.py its own ec_add, ec_dbl and msm_scan; ops/straus.py
    and models/preprocess_device.py group_kernels.ec_add and
    ec_mixed_add), so only their calls are timed.  The events enclose the
    wrapper, so a sum includes its small tensor conversions beside the
    kernel."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.events = []
        self.saved = {}

    def _timed(self, label, fn):
        import torch

        def call(cops, *args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(cops, *args, **kwargs)
            e1.record()
            self.events.append((label, cops.cfg, e0, e1))
            return out
        return call

    def __enter__(self):
        for label, (mod, attr) in self.targets.items():
            self.saved[label] = getattr(mod, attr)
            setattr(mod, attr, self._timed(label, self.saved[label]))
        return self

    def __exit__(self, *exc):
        for label, fn in self.saved.items():
            mod, attr = self.targets[label]
            setattr(mod, attr, fn)

    def totals(self) -> dict:
        """(name, cfg) -> (calls, summed device ms)."""
        import torch
        torch.cuda.synchronize()
        out = {}
        for name, cfg, e0, e1 in self.events:
            calls, ms = out.get((name, cfg), (0, 0.0))
            out[name, cfg] = (calls + 1, ms + e0.elapsed_time(e1))
        return out


class UploadTimer:
    """CUDA events around each call of ops/msm.upload_block, recorded on
    the stream it runs on (the copy stream of the host-resident rows):
    totals() gives (uploads, summed device ms, bytes); `stray` counts the
    uploads whose source was not pinned or that ran on the default
    stream."""

    def __enter__(self):
        import torch
        from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
        self.M, self.saved = M, M.upload_block
        self.events = []
        self.stray = 0

        def timed(pinned, device):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            if not pinned.is_pinned() or (torch.cuda.current_stream(device)
                                          == torch.cuda.default_stream(
                                              device)):
                self.stray += 1
            e0.record()
            out = self.saved(pinned, device)
            e1.record()
            self.events.append((e0, e1, pinned.numel() * 4))
            return out
        M.upload_block = timed
        return self

    def __exit__(self, *exc):
        self.M.upload_block = self.saved

    def totals(self):
        import torch
        torch.cuda.synchronize()
        return (len(self.events),
                sum(e0.elapsed_time(e1) for e0, e1, _ in self.events),
                sum(nb for _, _, nb in self.events))


class CollectiveTimer:
    """Host clock around each exchange of parallel/sharded.Comm, with the
    card drained before and after, so a sum is the exchange alone (on
    gloo its staging copies through host memory included): name ->
    [calls, seconds]."""

    NAMES = ("all_to_all", "all_gather")

    def __enter__(self):
        import torch
        from gpu_groth16_prover_3x_tpu_torch.parallel import sharded as SH
        self.Comm = SH.Comm
        self.saved = {k: getattr(SH.Comm, k) for k in self.NAMES}
        self.calls = {k: [0, 0.0] for k in self.NAMES}

        def timed(name, fn):
            def call(comm, x):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(comm, x)
                torch.cuda.synchronize()
                self.calls[name][0] += 1
                self.calls[name][1] += time.perf_counter() - t
                return out
            return call
        for name, fn in self.saved.items():
            setattr(SH.Comm, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.Comm, name, fn)


class StreamedWidths:
    """The streamed MSMs that parallel/sharded.sharded_msm_window_sums
    hands a rank's rows to (ops/msm.msm_window_sums_streamed): per call
    its group configuration, the widths of its keys, rows and segment
    ids, its chunk, the block it walks and where its rows lay."""

    def __enter__(self):
        from gpu_groth16_prover_3x_tpu_torch.parallel import sharded as SH
        self.SH, self.saved, self.calls = SH, SH.msm_window_sums_streamed, []

        def keep(cops, keys, rows, chunk_s, c, seg, num, block, *args):
            self.calls.append(dict(
                cfg=cops.cfg, keys=keys.shape[1], rows=rows.shape[0],
                seg=None if seg is None else seg.shape[0], chunk=chunk_s,
                block=block, rows_on="host" if isinstance(rows, np.ndarray)
                else "device"))
            return self.saved(cops, keys, rows, chunk_s, c, seg, num, block,
                              *args)
        SH.msm_window_sums_streamed = keep
        return self

    def __exit__(self, *exc):
        self.SH.msm_window_sums_streamed = self.saved


def grid_faults(calls: list, block_points: int, ndev: int) -> list:
    """What a rank's streamed MSMs (StreamedWidths.calls, one G1 and one
    B2) break of rows staged once: keys, rows and segment ids of one
    width that their block grid covers exactly, walked in the rank's
    share of the global block_points (nothing padded again)."""
    from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
    from gpu_groth16_prover_3x_tpu_torch.parallel import sharded as SH
    out = [] if len(calls) == 2 else [f"{len(calls)} streamed MSMs, not 2"]
    for k in calls:
        nblk, per = M.block_grid(k["rows"], k["chunk"], k["block"])
        if k["keys"] != k["rows"] or k["seg"] not in (None, k["rows"]) or \
                nblk * per != k["rows"] or \
                k["block"] != SH.rank_block(block_points, ndev, k["chunk"]):
            out.append(f"cfg {k['cfg']}: keys {k['keys']}, rows {k['rows']}"
                       f", segment ids {k['seg']}, block {k['block']}: the "
                       f"grid is {nblk} x {per}")
    return out


def sharded_rank(rank: int, name: str, workdir: str) -> dict:
    """One rank of the SHARDED run `name`: the whole key and input loaded
    (from workdir's files, or made in memory from the seed), then
    prove_sharded, unforced, under the timers and StreamedWidths; A, B
    and C against the known logs, H's log summed over every rank's
    domain slice."""
    world, log2, _, files = SHARDED[name]
    from gpu_groth16_prover_3x_tpu_torch.parallel import prover as PP
    ch = Child(os.getppid(), f"rank {rank}/{world} ")
    torch, GP = ch.torch, ch.GP
    import torch.distributed as dist
    from gpu_groth16_prover_3x_tpu_torch.curves.constants import MNT4753
    from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK
    from gpu_groth16_prover_3x_tpu_torch.ops import mont_mul as MM
    from gpu_groth16_prover_3x_tpu_torch.ops import msm as M
    from gpu_groth16_prover_3x_tpu_torch.utils import opcount, profiling
    from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

    curve = MNT4753
    t0 = time.time()
    if files:
        params = GP.load_params(os.path.join(
            workdir, f"{curve.name}-parameters"), curve)
        inputs = GP.load_input(os.path.join(workdir, f"{curve.name}-input"),
                               curve, params.d, params.m)
    else:
        params = SY.params_arrays(curve, log2)
        inputs = SY.input_arrays(SY.input_values(
            curve, log2, np.random.default_rng(SEED + log2)))
    inputs_s = time.time() - t0
    ch.mark("key and input in memory")
    grid = rank_grid(log2, world, rank)
    counters = {"mont_mul": MM.MONT_MUL, "ec_add": GK.EC_ADD,
                "ec_dbl": GK.EC_DBL, "msm_scan": M.MSM_SCAN}
    if world > 1:
        dist.barrier()          # start the proofs together
    for k in counters.values():
        k.launches = 0
    profiling.clear_laps()
    t1 = time.time()
    with CollectiveTimer() as coll, UploadTimer() as up, \
            KernelTimer({"msm_scan": (M, "msm_scan")}) as scan, \
            StreamedWidths() as widths, opcount.collect() as tally:
        proof = PP.prove_sharded(curve, params, inputs)
        torch.cuda.synchronize()
    wall = time.time() - t1
    launches = {n: k.launches for n, k in counters.items()}
    laps = profiling.last_laps()
    uploads = up.totals()
    scans = {cfg: n for (_, cfg), (n, _) in scan.totals().items()}
    del params
    h = ch.h_std[0]
    h_logs = [None] * world
    dist.all_gather_object(h_logs, SY.h_log(SY.KS, SY.query_logs(log2), h,
                                            rank * h.shape[1]))
    want = SY.known_proof(curve, SY.KS, SY.query_logs(log2),
                          inputs.w_mont.T, sum(h_logs), inputs.r)
    ok = proof == want
    print(f"rank {rank}/{world} MNT4753 2^{log2}: prove_sharded {wall:.2f} s"
          f" (key and input {inputs_s:.1f} s), A, B, C "
          f"{'equal' if ok else 'DIFFER FROM'} the known logs; launches "
          f"{launches}; scans {scans}, grid {grid}; collectives "
          f"{coll.calls}; uploads {uploads}", flush=True)
    return dict(rank=rank, world=world, ok=ok, proof=proof, wall_s=wall,
                inputs_s=inputs_s, laps=laps, launches=launches,
                scans=scans, grid=grid, msms=widths.calls,
                collectives=coll.calls, uploads=uploads,
                sent_bytes={k: tally.get(k, 0) for k in (
                    "all_to_all_bytes", "all_gather_bytes")},
                peak_device_bytes=torch.cuda.max_memory_allocated(),
                peak_host_bytes=peak_rss_bytes(), marks=ch.marks)


def rank_faults(r: dict) -> list:
    """What a rank's result breaks of the run's checks: the known logs,
    a launch of each kernel, the grid's scan launches, rows and keys
    staged once at the grid of blocks of STREAM_BLOCK a rank."""
    from gpu_groth16_prover_3x_tpu_torch.models.gpu_prover import \
        STREAM_BLOCK
    out = [] if r["ok"] else ["A, B, C differ from the known logs"]
    out += [f"{k} never launched" for k, v in r["launches"].items() if not v]
    for cfg, (_, nblk, _, want) in r["grid"].items():
        if r["scans"].get(cfg, 0) != want:
            out.append(f"cfg {cfg}: {r['scans'].get(cfg, 0)} scan launches,"
                       f" the grid's {nblk} blocks give {want}")
    return out + grid_faults(r["msms"], STREAM_BLOCK * r["world"],
                             r["world"])


def sharded_child(name: str, workdir: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("prove_at_scale: no CUDA card", file=sys.stderr)
        return 1
    world, log2, backend, files = SHARDED[name]
    sys.path.insert(0, ROOT)
    from gpu_groth16_prover_3x_tpu_torch.curves.constants import MNT4753
    from gpu_groth16_prover_3x_tpu_torch.ops import build
    from gpu_groth16_prover_3x_tpu_torch.parallel import multihost
    from gpu_groth16_prover_3x_tpu_torch.utils import native
    from gpu_groth16_prover_3x_tpu_torch.utils import synthetic as SY

    res = dict(run=name, world=world, log2=log2, backend=backend)
    t0 = time.time()
    if files:
        SY.write_synthetic(MNT4753, log2, workdir,
                           np.random.default_rng(SEED + log2))
    res["files_s"] = time.time() - t0
    t0 = time.time()
    build.library()             # once, before the ranks load them
    native.available()
    res["kernel_build_s"] = time.time() - t0
    t0 = time.time()
    ranks = multihost.launch_local(sharded_rank, world, (name, workdir),
                                   backend=backend, timeout=CHILD_TIMEOUT)
    res["wall_s"] = time.time() - t0
    same = all(r["proof"] == ranks[0]["proof"] for r in ranks)
    faults = {r["rank"]: rank_faults(r) for r in ranks}
    for r in ranks:
        print(f"rank {r['rank']}/{world}: laps {r['laps']}; peak device "
              f"{r['peak_device_bytes'] / 2**30:.2f} GiB; sent "
              f"{r['sent_bytes']}; streamed MSMs {r['msms']}; faults "
              f"{faults[r['rank']] or 'none'}", flush=True)
    res["ok"] = same and not any(faults.values())
    res["peak_card_used_marks_bytes"] = max(
        m["card_used_bytes"] for r in ranks for m in r["marks"])
    print(f"{name}: MNT4753 2^{log2} over {world} {backend} rank(s) in "
          f"{res['wall_s']:.2f} s: every rank's proof "
          f"{'is the same' if same else 'is NOT the same'}; "
          f"{'ok' if res['ok'] else 'FAILED'}", flush=True)
    res.update(same_proof=same, faults=faults, ranks=[
        {k: v for k, v in r.items() if k != "proof"} for r in ranks])
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


# -- the parent: children under a host-memory watch ------------------------------

def watch_child(args: list, cwd: str, disk_dir: str) -> dict:
    """Run `prove_at_scale.py --child *args` from `cwd` and watch it: the
    summed resident set of its process tree (the whole tree stopped past
    the cap), the card's used memory (peak_card_used_bytes, sampled about
    once a second) and the used bytes of the file system that holds
    disk_dir (peak_disk_used_bytes)."""
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
    peak_card, card_at = card_used_bytes(), time.time()
    while proc.poll() is None:
        rss = tree_rss_bytes(proc.pid)
        peak_rss = max(peak_rss, rss)
        peak_disk = max(peak_disk, shutil.disk_usage(disk_dir).used)
        if peak_card is not None and time.time() - card_at > 1.0:
            peak_card = max(peak_card, card_used_bytes() or 0)
            card_at = time.time()
        if rss > cap:
            stopped = (f"host RSS {rss / 2**30:.1f} GiB past the cap of "
                       f"{cap / 2**30:.1f} GiB in phase '{phase[0]}'")
            kill_tree(proc.pid)
        elif time.time() - t0 > CHILD_TIMEOUT:
            stopped = f"over {CHILD_TIMEOUT} s in phase '{phase[0]}'"
            kill_tree(proc.pid)
        time.sleep(0.05)
    proc.wait()
    reader.join(timeout=60)
    res = {"ok": False}
    if lines and lines[-1].startswith("{"):
        res = json.loads(lines[-1])
    res.update(rc=proc.returncode, watched_peak_rss_bytes=peak_rss,
               peak_card_used_bytes=peak_card, last_phase=phase[0],
               peak_disk_used_bytes=peak_disk)
    if stopped:
        res["stopped"] = stopped
    elif proc.returncode:
        res["stopped"] = (f"exit {proc.returncode} in phase '{phase[0]}'")
    print(f"== {' '.join(args[:2])}: " + (
        f"STOPPED: {res['stopped']}" if "stopped" in res else "done")
          + f"; watched host RSS peak {peak_rss / 2**30:.2f} GiB"
          + ("" if peak_card is None else
             f", card used peak {peak_card / 2**30:.2f} GiB"), flush=True)
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


def run_sharded(name: str) -> dict:
    """A SHARDED run in a work directory of its own (its key files, and
    no stray table file), removed whatever happens."""
    work = tempfile.mkdtemp(prefix=f"sharded-{name}-")
    try:
        base = shutil.disk_usage(work).used
        res = watch_child([name, work], work, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res.update(run=name, peak_disk_bytes=res["peak_disk_used_bytes"] - base,
               ranks=[{k: r.get(k) for k in (
                   "rank", "ok", "wall_s", "inputs_s", "laps",
                   "peak_device_bytes", "peak_host_bytes", "launches",
                   "scans", "grid", "collectives", "sent_bytes", "uploads")}
                   for r in res.get("ranks", [])])
    return res


def run_steps(run: str) -> list:
    """A run of steps, each a watched child, in one work directory that
    is removed whatever happens (table files included): the 2^20 table
    workflow, or a KEY_RUNS run.  The Pippenger step runs from the
    work directory's `pippenger`, which holds no table file.  A step that
    fails ends the run."""
    steps = TABLE_STEPS if run == str(TABLE_LOG2) else KEY_RUNS[run][1]
    work = tempfile.mkdtemp(prefix=f"{run}-")
    pip = os.path.join(work, PIPPENGER_DIR)
    os.mkdir(pip)
    out = []
    try:
        base = shutil.disk_usage(work).used
        for step in steps:
            res = watch_child([run, step, work],
                              pip if step == "pippenger" else work, work)
            res.update(run=run, step=step, peak_disk_bytes=(
                res["peak_disk_used_bytes"] - base))
            out.append(res)
            if not res["ok"] or "stopped" in res:
                break
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if run == str(TABLE_LOG2) and len(out) == len(steps):
        same = out[1]["sha256"] == out[2]["sha256"]
        print(f"== 2^{TABLE_LOG2}: the table proof's sha256 "
              f"{'equals' if same else 'DIFFERS FROM'} the Pippenger "
              f"proof's", flush=True)
        if not same:
            out[1]["stopped"] = "sha256 differs from the Pippenger proof"
    elif len(out) < len(steps):
        out[-1].setdefault("stopped", f"steps {steps[len(out):]} not run")
    return out


def main(argv) -> int:
    if len(argv) >= 1 and argv[0] == "--child":
        if len(argv) == 4 and argv[1] in KEY_RUNS:
            return key_child(*argv[1:])
        if len(argv) == 4:
            return table_child(argv[2], argv[3])
        if argv[1] in SHARDED:
            return sharded_child(argv[1], argv[2])
        return child(int(argv[1]), argv[2])
    runs = argv or ["24", "25"]
    bad = [a for a in runs if a not in SHARDED and a not in KEY_RUNS
           and a not in ("20", "24", "25")]
    if bad:
        print(f"prove_at_scale: unknown run(s) {bad}: give 20, 24, 25 or "
              f"one of {sorted(SHARDED) + sorted(KEY_RUNS)}",
              file=sys.stderr)
        return 2
    for cmd in (["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], ["free", "-g"],
                ["df", "-h", tempfile.gettempdir(), ROOT]):
        print("$ " + " ".join(cmd), flush=True)
        print(subprocess.run(cmd, capture_output=True, text=True).stdout,
              flush=True)
    results = []
    for k in runs:
        if k in SHARDED:
            results.append(run_sharded(k))
        elif k in KEY_RUNS or k == str(TABLE_LOG2):
            results += run_steps(k)
        else:
            results.append(run_child(int(k)))
    print(json.dumps({"prove_at_scale": [
        {k: r.get(k) for k in (
            "run", "log2", "step", "ok", "resident", "wall_s", "files_s",
            "kernel_build_s", "steps", "lines", "laps", "file_bytes",
            "sha256", "peak_device_bytes", "peak_host_bytes",
            "watched_peak_rss_bytes", "peak_card_used_bytes",
            "peak_card_used_marks_bytes",
            "peak_disk_bytes", "world", "backend", "same_proof", "faults",
            "ranks", "curves", "stopped")}
        for r in results]}), flush=True)
    return 0 if results and all(r["ok"] and "stopped" not in r
                                for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
