"""Smoke run of the PyTorch/CUDA prover on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. build the CUDA kernels from gpu_groth16_prover_3x_tpu_torch/csrc and
     print the ptxas register/spill report, the card's name and power
     limit;
  2. hold every kernel against its plain PyTorch version on the card, on
     random canonical inputs from a numpy seed: exact equality;
  3. sha gate: `gpu <CURVE> compute` on the committed fixtures of
     tests/data/torch_port must reproduce the committed proof hashes;
  4. the main path at full size: one MNT4753 proof at d + 1 = 2^20 (the
     reference's default) and one MNT6753 proof at 2^15 (its G2 is over
     Fq3; 2^15 is the largest power-of-two domain of its Fr), from
     synthetic parameters with known discrete logs, through prove_files; A, B and C are checked against the known logs, and the
     H polynomial of the kernels against the plain H pipeline on the card.
     The launch counts are set to 0 just before each proof and read just
     after it: every kernel of the path must have launched in each.
The last lines are the kernel JSON, the card line and the result line.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the smoke needs one card: show it only the first visible one
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from gpu_groth16_prover_3x_tpu_torch.curves.constants import (  # noqa: E402
    MNT4753, MNT6753, R)
from gpu_groth16_prover_3x_tpu_torch.host import ec as HE  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops import build  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import mont_mul as MM  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops.ntt import NttPlan, compute_h  # noqa
from gpu_groth16_prover_3x_tpu_torch.utils import cli  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils import profiling  # noqa: E402

SEED = 20261016
DEV = "cuda"               # a CPU rehearsal of the script sets "cpu"
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_port")

# Published H100 SXM peaks (NVIDIA H100 datasheet): 3.35 TB/s of HBM
# and 67 TFLOP/s of float32 outside the tensor cores, i.e. 33.5e12 fused
# multiply-adds/s on 128 float32 lanes per SM.  An SM has half as many
# 32-bit integer lanes (64), so the 32-bit integer multiply-add peak is
# half of that: 16.75e12/s.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 33.5e12 / 2
# One 24-word CIOS: 2 * 24^2 word products, each a low and a high 32-bit
# multiply-add.
MADS_PER_FQ_MUL = 2 * 2 * 24 * 24
# Fq products per group op by extension degree (Karatsuba: Fq2 3, Fq3 6
# per extension product; the b3 constant multiplies coefficient-wise).
FQ_MULS = {"add": {1: 14, 2: 40, 3: 78}, "dbl": {1: 13, 2: 37, 3: 72},
           "mixed_add": {1: 13, 2: 37, 3: 72}}
REPLACES = {
    "mont_mul": "gpu_groth16_prover_3x_tpu/ops/pallas_kernels.py:121",
    "ec_add": "gpu_groth16_prover_3x_tpu/ops/pallas_group.py:267",
    "ec_dbl": "gpu_groth16_prover_3x_tpu/ops/pallas_group.py:267",
    "msm_scan": "gpu_groth16_prover_3x_tpu/ops/pallas_group.py:490",
}
SOURCES = {"mont_mul": "gpu_groth16_prover_3x_tpu_torch/csrc/mont_mul.cu",
           "ec_add": "gpu_groth16_prover_3x_tpu_torch/csrc/group.cu",
           "ec_dbl": "gpu_groth16_prover_3x_tpu_torch/csrc/group.cu",
           "ec_mixed_add": "gpu_groth16_prover_3x_tpu_torch/csrc/group.cu",
           "msm_scan": "gpu_groth16_prover_3x_tpu_torch/csrc/msm_scan.cu"}
COUNTERS = {"mont_mul": MM.MONT_MUL, "ec_add": GK.EC_ADD,
            "ec_dbl": GK.EC_DBL, "ec_mixed_add": GK.EC_MIXED_ADD,
            "msm_scan": M.MSM_SCAN}
PATH_KERNELS = ("mont_mul", "ec_add", "ec_dbl", "msm_scan")


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(ops: float, nbytes: float):
    t_ops = ops / INT32_MAD_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def require_equal(name: str, got, want) -> int:
    """Exact equality of kernel and plain outputs; returns the max
    absolute difference (0)."""
    got = (got,) if torch.is_tensor(got) else got
    want = (want,) if torch.is_tensor(want) else want
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs difference {err})")
    return err


# -- random canonical inputs -----------------------------------------------------

def rand_canon(rng, p: int, shape) -> np.ndarray:
    """(24, *shape) int32 words of values below p (the top word is drawn
    below p's top word)."""
    w = rng.integers(0, 1 << 32, size=(L.NWORDS,) + tuple(shape),
                     dtype=np.uint64)
    w[-1] %= p >> (32 * (L.NWORDS - 1))
    return w.astype(np.uint32).view(np.int32)


def rand_points(rng, cops, n: int, ncoord: int) -> np.ndarray:
    """(ncoord*deg, 24, n) random canonical coordinates; for projective
    points every 7th lane is the identity (0 : 1 : 0)."""
    out = np.stack([rand_canon(rng, cops.p, (n,))
                    for _ in range(ncoord * cops.deg)])
    if ncoord == 3:
        ident = M.identity_words(cops, 1, "cpu").numpy()[..., 0]
        out[:, :, ::7] = ident[:, :, None]
    return out


# -- phase 2: kernels against plain versions --------------------------------------

def check_mont_mul(rng, n: int, results: dict) -> None:
    for p in (MNT4753.fr.p, MNT4753.fq.p):
        ctx = L.MontCtx(p)
        a = rand_canon(rng, p, (n,))
        b = rand_canon(rng, p, (n,))
        a[:, 0] = 0
        a[:, 1] = L.int_to_words(p - 1)
        b[:, 1] = L.int_to_words(p - 1)
        at, bt = torch.from_numpy(a).to(DEV), torch.from_numpy(b).to(DEV)
        got = MM.mont_mul(ctx, at, bt)
        want = MM.mont_mul_plain(ctx, at, bt)
        err = require_equal(f"mont_mul prime {ctx.prime_id}", got, want)
        ms = cuda_ms(lambda: MM.mont_mul(ctx, at, bt), 20)
        plain = cuda_ms(lambda: MM.mont_mul_plain(ctx, at, bt), 1)
        bnd, by = bound_ms(n * MADS_PER_FQ_MUL, n * 3 * 96)
        log(f"mont_mul prime {ctx.prime_id} n={n}: kernel {ms:.4f} ms, "
            f"plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})")
        if ctx.prime_id == 1:   # Fq of MNT4753 = Fr of MNT6753
            continue
        results["mont_mul"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                   bound_by=by, max_abs_err=err,
                                   shape=f"(24, {n})")


def check_group(rng, n: int, results: dict) -> None:
    for curve, group in ((MNT4753, "g1"), (MNT4753, "g2"),
                         (MNT6753, "g1"), (MNT6753, "g2")):
        cops = get_curve_ops(curve, group)
        deg = cops.deg
        P = torch.from_numpy(rand_points(rng, cops, n, 3)).to(DEV)
        Q = torch.from_numpy(rand_points(rng, cops, n, 3)).to(DEV)
        Q[:, :, 5::11] = P[:, :, 5::11]        # doublings through add
        xy = torch.from_numpy(rand_points(rng, cops, n, 2)).to(DEV)
        inf = torch.from_numpy(rng.random(n) < 0.1).to(DEV)
        xy[deg:, :, inf] = 0                   # infinity is y == 0
        cases = (
            ("ec_add", "add", lambda: GK.ec_add(cops, P, Q),
             lambda: GK.ec_add_plain(cops, P, Q), 9),
            ("ec_dbl", "dbl", lambda: GK.ec_dbl(cops, P),
             lambda: GK.ec_dbl_plain(cops, P), 6),
            ("ec_mixed_add", "mixed_add",
             lambda: GK.ec_mixed_add(cops, P, xy, inf),
             lambda: GK.ec_mixed_add_plain(cops, P, xy, inf), 8))
        for name, op, kern, plain_fn, ncoords in cases:
            err = require_equal(f"{name} cfg {cops.cfg}", kern(),
                                plain_fn())
            ms = cuda_ms(kern, 5)
            plain = cuda_ms(plain_fn, 1)
            bnd, by = bound_ms(n * FQ_MULS[op][deg] * MADS_PER_FQ_MUL,
                               n * ncoords * deg * 96)
            log(f"{name} {curve.name} {group} n={n}: kernel {ms:.3f} ms, "
                f"plain {plain:.2f} ms, bound {bnd:.4f} ms ({by})")
            if cops.cfg == 0:
                results[name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                     bound_by=by, max_abs_err=err,
                                     shape=f"G1 x {n}")


def scan_inputs(rng, cops, S: int, B: int, nrows: int):
    rows = np.stack([rand_canon(rng, cops.p, (nrows,))
                     for _ in range(2 * cops.deg)])     # (2deg, 24, nrows)
    rows[cops.deg:, :, rng.random(nrows) < 0.05] = 0     # infinity rows
    rows = np.ascontiguousarray(
        rows.reshape(2 * cops.deg * L.NWORDS, nrows).T)
    step = rng.integers(0, 4, size=(S, B)) * (rng.random((S, B)) < 0.4)
    step[:, ::13] = 0                                   # uniform chunks
    keys = np.cumsum(step, 0).astype(np.int32)
    idx = rng.integers(0, nrows, size=(S, B)).astype(np.int32)
    signs = rng.random((S, B)) < 0.5
    return rows, idx, keys, signs


def check_scan(rng, S: int, widths: dict, results: dict) -> None:
    for (curve, group), B in widths.items():
        cops = get_curve_ops(curve, group)
        rows, idx, keys, signs = scan_inputs(rng, cops, S, B, 4 * B)
        rt, it, kt, st = (torch.from_numpy(a).to(DEV)
                          for a in (rows, idx, keys, signs))
        got = M.msm_scan(cops, rt, it, kt, st)
        want = M.msm_scan_plain(cops, rt, it, kt, st)
        err = require_equal(f"msm_scan cfg {cops.cfg}", got, want)
        # unsigned digits: no sign array
        err = max(err, require_equal(f"msm_scan cfg {cops.cfg} unsigned",
                                     M.msm_scan(cops, rt, it, kt),
                                     M.msm_scan_plain(cops, rt, it, kt)))
        ms = cuda_ms(lambda: M.msm_scan(cops, rt, it, kt, st), 3)
        plain = cuda_ms(lambda: M.msm_scan_plain(cops, rt, it, kt, st), 1)
        deg = cops.deg
        inf_row = np.all(rows[:, deg * 24:] == 0, axis=1)
        adds = int(np.sum((keys[1:] == keys[:-1]) & ~inf_row[idx[1:]]))
        nbytes = S * B * (2 * deg * 96 + 9) + (S - 1) * B * (
            3 * deg * 96 + 1) + B * (2 * 3 * deg * 96 + 1)
        bnd, by = bound_ms(adds * FQ_MULS["mixed_add"][deg]
                           * MADS_PER_FQ_MUL, nbytes)
        log(f"msm_scan {curve.name} {group} S={S} B={B}: kernel {ms:.2f} "
            f"ms, plain {plain:.1f} ms, bound {bnd:.3f} ms ({by}), "
            f"{adds} mixed adds")
        if cops.cfg == 0:
            results["msm_scan"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                       bound_by=by, max_abs_err=err,
                                       shape=f"S={S}, B={B}")


# -- phase 3: fixture sha gate --------------------------------------------------------

def fixture_gate(workdir: str) -> None:
    want = {}
    with open(os.path.join(FIXTURES, "SHA256SUMS")) as f:
        for line in f:
            digest, name = line.split()
            want[name] = digest
    for curve in ("MNT4753", "MNT6753"):
        out = os.path.join(workdir, f"{curve}-output")
        rc = cli.main(["gpu", curve, "compute",
                       os.path.join(FIXTURES, f"{curve}-parameters"),
                       os.path.join(FIXTURES, f"{curve}-input"), out,
                       "--device", DEV])
        with open(out, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if rc != 0 or got != want[f"{curve}-output"]:
            raise AssertionError(f"{curve} fixture proof sha256 {got} != "
                                 f"{want[f'{curve}-output']}")
        log(f"fixture gate {curve}: sha256 {got} ok")


# -- phase 4: the main path at full size ----------------------------------------------

NBASE = 64


def _affine_words(hg, pt, deg: int, p: int) -> np.ndarray:
    x, y = hg.to_affine(pt)
    cs = [x, y] if deg == 1 else list(x) + list(y)
    return np.concatenate([L.int_to_words(c * R % p) for c in cs])


def write_synthetic(curve, log2: int, workdir: str, rng):
    """Params whose rows tile known multiples k_j * G (k_j = 3 + 7j), and
    random inputs; returns (paths, known logs, scalars)."""
    d1 = 1 << log2
    d, m = d1 - 1, d1
    p = curve.fq.p
    hg1, hg2 = HE.g1_group(curve), HE.g2_group(curve)
    g1, g2 = HE.g1_generator(curve), HE.g2_generator(curve)
    ks = [3 + 7 * j for j in range(NBASE)]
    base1 = np.stack([_affine_words(hg1, hg1.mul(k, g1), 1, p) for k in ks])
    base2 = np.stack([_affine_words(hg2, hg2.mul(k, g2), curve.ext_degree,
                                    p) for k in ks])

    def tile(base, count, shift):
        return np.roll(base, -shift, 0)[np.arange(count) % NBASE]

    logs = {"A": (m + 1, 0), "B1": (m + 1, 1), "L": (m - 1, 2),
            "H": (d, 3), "B2": (m + 1, 0)}
    params = os.path.join(workdir, f"{curve.name}-parameters")
    with open(params, "wb") as f:
        f.write(np.array([d, m], "<u8").tobytes())
        for name in ("A", "B1", "B2", "L", "H"):
            count, shift = logs[name]
            base = base2 if name == "B2" else base1
            f.write(tile(base, count, shift).tobytes())
    fr = curve.fr.p
    w, ca, cb, cc = (rand_canon(rng, fr, (n,)) for n in (m + 1, d1, d1, d1))
    r_in = int(rng.integers(1, 1 << 62))
    inp = os.path.join(workdir, f"{curve.name}-input")
    with open(inp, "wb") as f:
        for a in (w, ca, cb, cc):
            f.write(np.ascontiguousarray(a.T).tobytes())
        f.write((r_in * R % fr).to_bytes(96, "little"))
    return params, inp, ks, logs, (w, ca, cb, cc, r_in)


def known_log(ks, count: int, shift: int, scalars) -> dict:
    """sum_i scalars[i] * k_{(i + shift) mod NBASE}, grouped by class."""
    acc = [0] * NBASE
    for i, s in enumerate(scalars[:count]):
        acc[(i + shift) % NBASE] += s
    return sum(a * k for a, k in zip(acc, ks))


def read_proof(path: str, curve):
    p, deg = curve.fq.p, curve.ext_degree
    rinv = pow(R, -1, p)
    with open(path, "rb") as f:
        raw = f.read()
    vals = [int.from_bytes(raw[i:i + 96], "little") * rinv % p
            for i in range(0, len(raw), 96)]
    a = (vals[0], vals[1])
    b = (tuple(vals[2:2 + deg]), tuple(vals[2 + deg:2 + 2 * deg]))
    c = tuple(vals[2 + 2 * deg:4 + 2 * deg])
    return a, b, c


def full_proof(curve, log2: int, workdir: str, rng):
    t0 = time.time()
    params, inp, ks, logs, (w, ca, cb, cc, r_in) = write_synthetic(
        curve, log2, workdir, rng)
    log(f"{curve.name} 2^{log2}: synthetic files written in "
        f"{time.time() - t0:.1f} s")
    out = os.path.join(workdir, f"{curve.name}-output")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in COUNTERS.values():
        k.launches = 0
    t1 = time.time()
    GP.prove_files(curve, params, inp, out, device=DEV)
    wall = time.time() - t1
    launches = {n: k.launches for n, k in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    laps = profiling.last_laps()
    log(f"{curve.name} 2^{log2}: prove_files {wall:.2f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB")
    for name, dt in laps.items():
        log(f"  phase {name}: {dt:.3f} s")
    log(f"  launches: {launches}")
    missing = [n for n in PATH_KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{curve.name} proof never launched {missing}")

    # H: kernels against the plain pipeline on the card, same inputs
    fr = curve.fr
    dev_in = [torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
              for a in (ca, cb, cc)]
    h_k = compute_h(NttPlan(fr, 1 << log2, DEV), *dev_in)
    h_p = compute_h(NttPlan(fr, 1 << log2, DEV,
                              mul=MM.mont_mul_plain),
                    *dev_in)
    require_equal(f"{curve.name} H pipeline", h_k, h_p)
    h_std = L.words_to_ints(h_k[1].cpu().numpy())

    rinv = pow(R, -1, fr.p)
    wstd = [v * rinv % fr.p for v in L.words_to_ints(w)]
    m = len(wstd) - 1
    sA = known_log(ks, *logs["A"], wstd)
    sB1 = known_log(ks, *logs["B1"], wstd)
    sB2 = known_log(ks, *logs["B2"], wstd)
    sL = known_log(ks, logs["L"][0], logs["L"][1], wstd[2:])
    sH = known_log(ks, *logs["H"], h_std)
    hg1, hg2 = HE.g1_group(curve), HE.g2_group(curve)
    g1, g2 = HE.g1_generator(curve), HE.g2_generator(curve)
    want = (hg1.to_affine(hg1.mul(sA % fr.p, g1)),
            hg2.to_affine(hg2.mul(sB2 % fr.p, g2)),
            hg1.to_affine(hg1.mul((sH + sL + r_in * sB1) % fr.p, g1)))
    got = read_proof(out, curve)
    for name, g, wv in zip("ABC", got, want):
        if g != tuple(wv):
            raise AssertionError(f"{curve.name} 2^{log2}: proof {name} "
                                 f"disagrees with the known logs")
    log(f"{curve.name} 2^{log2}: A, B, C match the known logs (m = {m}); "
        f"H equals the plain pipeline")
    return dict(wall_s=wall, peak_bytes=peak, phases=laps,
                launches=launches)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    card = card_line()
    log(f"card: {card}")

    t0 = time.time()
    build.library()
    log(f"build: {time.time() - t0:.1f} s")
    log(build.ptxas_report())

    results = {}
    check_mont_mul(rng, 1 << 20, results)
    check_group(rng, 1 << 16, results)
    # B: the scan widths of the MNT4753 2^20 proof (G1: 2 windows x 2^15
    # chunks; G2: 6 windows x 8193 chunks) and of the MNT6753 2^15 proof
    # (c = 8: G1 48 windows x 1024 chunks; G2 96 windows x 257 chunks)
    check_scan(rng, 128, {(MNT4753, "g1"): 1 << 16,
                          (MNT4753, "g2"): 6 * 8193,
                          (MNT6753, "g1"): 48 * 1024,
                          (MNT6753, "g2"): 96 * 257}, results)
    log(f"kernel checks done at {time.time() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as workdir:
        fixture_gate(workdir)
        log(f"fixture gate done at {time.time() - t0:.1f} s")
        run4 = full_proof(MNT4753, 20, workdir, rng)
        run6 = full_proof(MNT6753, 15, workdir, rng)

    log(f"full-size proofs done at {time.time() - t0:.1f} s")
    kernels = []
    for name in PATH_KERNELS:
        r = results[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": run4["launches"][name],
                        "launches_mnt6753_2p15": run6["launches"][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if torch.cuda.device_count() != 1:
        raise AssertionError("the smoke runs on exactly one card")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
