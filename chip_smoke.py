"""Smoke run of the PyTorch/CUDA prover on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. build the CUDA kernels from gpu_groth16_prover_3x_tpu_torch/csrc and
     print the ptxas register/spill report, the card's name and power
     limit;
  2. hold every kernel against its plain PyTorch version on the card, on
     random canonical inputs from a numpy seed: exact equality; time the
     group kernels also at the widths of the halving reduction's first
     level in the MNT4753 2^20 proof (G1 192 x 2^14 lanes, Fq2 48 x 2^14);
  3. sha gate: `gpu <CURVE> compute` on the committed fixtures of
     tests/data/torch_port must reproduce the committed proof hashes;
  4. the main path at full size: one MNT4753 proof at d + 1 = 2^20 (the
     reference's default) and one MNT6753 proof at 2^15 (its G2 is over
     Fq3; 2^15 is the largest power-of-two domain of its Fr), from
     synthetic parameters with known discrete logs, through prove_files; A, B and C are checked against the known logs, and the
     proof's H polynomial against the plain H pipeline on the card and
     against the pipeline with its plain add/sub in blocks of 2^14 lanes.
     The launch counts are set to 0 just before each proof and read just
     after it: every kernel of the path must have launched in each.  CUDA
     events around the MSM's calls of ec_add, ec_dbl and msm_scan sum each
     kernel's device time within the proof, per group configuration;
  5. the streamed MSM: msm_window_sums_streamed on MNT4753 G1 with a forced
     block size (2^16 points in 4 blocks of 2^14, signed digits, c = 16,
     two fused MSMs) must finalise to the same group elements as the
     unstreamed pass;
  6. the table path through files at MNT6753 2^15: `gpu MNT6753 preprocess`
     on the phase-4 parameters (about 0.98 GB of tables), then `gpu MNT6753
     compute` beside the table file: its proof must have the sha256 of the
     phase-4 Pippenger proof.  Held against their plain versions on the
     card: ec_mixed_add on the first steps of the table build at its
     widths (2^15 + 1 and 2^15 - 1 lanes), the Straus tree of the B1 and
     B2 tables at the widths of the proof's (first level 151 x 2^14
     lanes) and the affine normalisation, the last also against host
     inversions;
  7. the table path at MNT4753 2^20, in memory: multiples_rows builds the
     B1, B2 and L tables on the card and prove(tables=...) takes the
     device tensors; A, B and C must match the known logs.  As in phase
     6, ec_mixed_add at 2^20 + 1 and 2^20 - 1 lanes and the Straus trees
     at the proof's first-level widths (G1 about 7.3 M lanes, Fq2 about
     3.7 M) are held against their plain versions.  The table file would
     be about 25 GB at this size, so writing and reading it back is left
     to phase 6;
  8. `gpu MNT4753 serve` at 2^20 with the phase-4 input and a fresh random
     one: one staging of the parameters, both proofs equal to their
     known logs;
  9. setup and the cpu oracle.  9a: the native host library loads, and
     its Horner epilogue equals finalize_msm on the window sums of the
     phase-4 proofs.  9b: `generate_parameters` at log2 6 for both curves
     through the CLI (the host oracle below 2^10) equals the device setup
     byte for byte, trapdoor files included, and `cpu compute` and `gpu
     compute` on those files write the same proof; batch_exp_device on
     the scan path (GROTH16_EXP_WINDOWED=0, 33 G1 and 33 Fq2 scalars)
     equals host multiples.  9c: real keys at working size, MNT4753 2^16
     and MNT6753 2^15, generated once each on the card, proved with `gpu
     compute` and checked by verify_with_trapdoor.  9d: batch_exp_device
     at MNT4753's 2^20 query size, G1 and Fq2, 256 sampled lanes against
     host multiples.  ec_add and ec_mixed_add (and ec_dbl on the scan
     path) are held against their plain versions at the setup's widths
     on the operands the setup gave them;
 10. the multi-device prover (parallel/), in ranks spawned by
     multihost.launch_local after the kernels are built.  10a:
     prove_sharded at world 1 on nccl on the phase-4 MNT4753 2^20 files:
     the proof equals phase 4's and the known logs.  10b: world 2 on
     gloo, both ranks on the one card (nccl refuses two ranks on one
     card), MNT4753 2^20 and MNT6753 2^15: each rank's proof equals
     phase 4's, and each rank's scan point-steps (utils/opcount) are half
     of 10a's up to padding.  Each rank reports its laps, peak memory,
     collectives (calls, seconds, bytes sent), launches and op tally;
     then a second proof in each rank captures the operands of the first
     bucket scan of each MSM, of the cross-rank combine's ec_add and of
     the NTT's mont_mul calls (each shape of at least n/4 lanes), which
     are held against their plain versions (the scan on 4,096 of its
     chunks, the others at full width).
     10c: the sharded MSM of 2^16 MNT4753 G1 points over the 2 ranks in
     global blocks of 2^14 equals the one pass.  10d: sharded_ntt at
     2^20 over the 2 ranks equals ops/ntt on one rank, forward and
     inverse, word for word.  A rank that raises or outlives its
     timeout fails the phase;
 11. streamed and host-resident query rows at their own sizes.  11a: an
     MNT4753 proof at d + 1 = 2^24 through prove_files with no forcing
     keeps its 19.3 GB of rows on the card, streams its 2^26 G1 rows in
     32 blocks of 2^21 and its B2 rows in 9 (checked by the scan launches
     per configuration) and equals its known logs; the plain H pipeline
     is left to phase 4's 2^20 proof.  11b: phase 4's MNT4753
     2^20 files in two sessions with blocks of 2^19 points, rows resident
     and rows in host memory (resident_bytes = 0): both proofs have phase
     4's sha256, the host session's peak device memory is at least half
     the rows' bytes below the resident one's, the uploads on the copy
     stream are timed (CUDA events) beside each MSM lap, and the first
     scan of each MSM in a second host-resident proof is held against
     the plain scan.  11c: prove_sharded at world 2 on gloo with each
     rank's G1 rows in host memory, MNT6753 2^15 in global blocks of
     2^16: every rank's proof equals phase 4's.  11d: an MNT4753 proof
     at d + 1 = 2^25 through a ProverSession on in-memory synthetic keys
     with no forcing: its 38.65 GB of rows pass 3/8 of the card and stay
     in host memory, each of its 81 blocks goes up from pinned memory on
     the copy stream (timed), A, B and C equal the known logs, and the
     first scan of each MSM is held against the plain scan.  It needs
     about 80 GiB of host memory and fails, saying so, on a host that
     has less.  11a and 11d print their laps, peak device memory and
     peak host RSS;
 12. the entry points of __graft_entry_torch__.py.  12a: entry()'s
     fn (the G1 window sums of 128 MNT4753 points, c = 8) on the card
     must launch msm_scan, ec_add and ec_dbl, equal fn on CPU copies of
     its args (the plain route) word for word, and finalise to the host
     MSM of its scalars; timed with CUDA events.  12b:
     dryrun_multichip(1) (nccl) and dryrun_multichip(2) (two gloo ranks
     on the one card): every rank's proof equals the unmasked host
     oracle's at 2^6, and every rank launched mont_mul, ec_add, ec_dbl
     and msm_scan; each call is timed.
 13. bench_torch.py as a subprocess at small sizes (msm 2^16, g2 2^12,
     ntt 2^16, 2 timed runs; the proof legs off: phases 4 and 9c prove
     the same files and keys): exit 0, a value, correct: true on every
     leg that ran, and the legs' own launch counts show msm_scan, ec_add
     and ec_dbl in the MSM legs and mont_mul in the NTT leg.
Every phase sets the launch counts to 0 before the run it reads and fails
if a kernel of that run's path never launched.
The last lines are the entry points' JSON (phase 12), the kernel JSON, the
card line and the result line.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
from gpu_groth16_prover_3x_tpu_torch.host import field as HF  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.host import groth16 as HG  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.host import msm as HM  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP  # noqa
from gpu_groth16_prover_3x_tpu_torch.models import \
    preprocess_device as PD  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.models import setup as SU  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.models import \
    setup_device as SD  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import build  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import group_kernels as GK  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops import limbs as L  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import mont_mul as MM  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import ntt as NT  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import msm as M  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops import straus as S  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops.inverse import \
    to_affine_rows  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops  # noqa
from gpu_groth16_prover_3x_tpu_torch.ops.ntt import (  # noqa: E402
    NttPlan, compute_h, intt, ntt)
from gpu_groth16_prover_3x_tpu_torch.parallel import multihost  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.parallel import \
    sharded as SH  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.parallel.prover import \
    prove_sharded  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils import cli  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils import native  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils import opcount  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils import profiling  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils.profiling import \
    card_line  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils import \
    serialization as SER  # noqa: E402
from gpu_groth16_prover_3x_tpu_torch.utils.synthetic import (  # noqa: E402
    KS, NBASE, affine_words, expected_proof, input_arrays, input_values,
    known_proof, params_arrays, query_logs, rand_canon, read_proof,
    write_input, write_synthetic)

import __graft_entry_torch__ as GE  # noqa: E402

SEED = 20261016
SETUP_SEED = 7
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
    "ec_mixed_add": "gpu_groth16_prover_3x_tpu/ops/pallas_group.py:267",
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
BUILD_KERNELS = ("mont_mul", "ec_mixed_add")
SETUP_KERNELS = ("mont_mul", "ec_add", "ec_mixed_add")
SCAN_KERNELS = ("mont_mul", "ec_dbl", "ec_mixed_add")
MSM_STRAUS = "MSMs (device: Straus tables + Pippenger A/H)"


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


# The plain group operations hold tens of KB of int64 temporaries a lane
# (about 40 KB for G1, 110 KB for Fq2): at the table path's widths they
# run this many lanes at a time.
PLAIN_LANES = 1 << 15
# chunks of a bucket scan at the main path's widths that its plain version
# (a Python loop over the chunk's steps) runs for the comparison
PLAIN_CHUNKS = 1 << 12


def lanewise(fn):
    """A plain group operation fn(cops, *operands) applied PLAIN_LANES
    lanes at a time; operands end in the lane axis."""
    def call(cops, *ops):
        n = ops[0].shape[-1]
        return torch.cat([fn(cops, *(t[..., a:a + PLAIN_LANES]
                                     for t in ops))
                          for a in range(0, n, PLAIN_LANES)], -1)
    return call


def cuda_once(fn):
    """fn() and its device time in ms over one call (CUDA events)."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


# -- random canonical inputs -----------------------------------------------------

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
        results["mont_mul", ctx.prime_id] = dict(
            ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
            max_abs_err=err, shape=f"(24, {n})",
            config=f"prime {ctx.prime_id}")


GROUPS = ((MNT4753, "g1"), (MNT4753, "g2"), (MNT6753, "g1"), (MNT6753, "g2"))
# lanes of the halving reduction's first level in the MNT4753 2^20 proof:
# (768 / 16 windows) x 4 fused MSMs (G1) or 1 (G2) groups of 2^15 buckets,
# paired once
PATH_LANES = {0: 192 << 14, 1: 48 << 14}


def config_name(cops) -> str:
    field = {1: "Fq", 2: "Fq2", 3: "Fq3"}[cops.deg]
    return f"{cops.curve.name} {cops.group.upper()} ({field})"


def check_group(rng, n: int, results: dict) -> None:
    for curve, group in GROUPS:
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
            results[name, cops.cfg] = dict(
                ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                max_abs_err=err, shape=f"{n} points",
                config=config_name(cops))
        del P, Q, xy
        if cops.cfg not in PATH_LANES:
            continue
        # the same kernels where the main path launches them widest
        wide = PATH_LANES[cops.cfg]
        P = torch.from_numpy(rand_points(rng, cops, n, 3)).to(DEV)
        P = P.repeat(1, 1, wide // n).contiguous()
        Q = P.roll(5, -1).contiguous()
        for name, op, kern, ncoords in (
                ("ec_add", "add", lambda: GK.ec_add(cops, P, Q), 9),
                ("ec_dbl", "dbl", lambda: GK.ec_dbl(cops, P), 6)):
            ms = cuda_ms(kern, 3)
            bnd, by = bound_ms(wide * FQ_MULS[op][deg] * MADS_PER_FQ_MUL,
                               wide * ncoords * deg * 96)
            log(f"{name} {curve.name} {group} n={wide} (reduction, first "
                f"level): kernel {ms:.3f} ms, bound {bnd:.4f} ms ({by})")
            results[name, cops.cfg].update(
                path_shape=f"{wide} points", path_ms=ms, path_bound_ms=bnd)
        del P, Q


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
        results["msm_scan", cops.cfg] = dict(
            ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
            max_abs_err=err, shape=f"S={S}, B={B}", config=config_name(cops))


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
        self.saved = M.upload_block
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
        M.upload_block = self.saved

    def totals(self):
        torch.cuda.synchronize()
        return (len(self.events),
                sum(e0.elapsed_time(e1) for e0, e1, _ in self.events),
                sum(nb for _, _, nb in self.events))


class Capture:
    """Keeps the arguments of calls of a module attribute (a wrapper the
    callers look up at each call, as KernelTimer's targets): of the calls
    for which keep(args) is true (all when keep is None), the index-th
    per group configuration (args[0].cfg; mont_mul's context has none),
    or every one when index is None.  The arguments are kept as given
    (tensors, not copies)."""

    def __init__(self, mod, attr: str, keep=None, index=None):
        self.mod, self.attr, self.keep, self.index = mod, attr, keep, index
        self.calls = []
        self.seen = {}

    def __enter__(self):
        self.saved = getattr(self.mod, self.attr)

        def call(*args):
            if self.keep is None or self.keep(args):
                cfg = getattr(args[0], "cfg", None)
                k = self.seen.get(cfg, 0)
                self.seen[cfg] = k + 1
                if self.index is None or k == self.index:
                    self.calls.append(args)
            return self.saved(*args)
        setattr(self.mod, self.attr, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.saved)


MSM_TARGETS = {name: (M, name) for name in ("ec_add", "ec_dbl", "msm_scan")}
TABLE_TARGETS = {"straus ec_add": (GK, "ec_add"),
                 "ec_mixed_add": (GK, "ec_mixed_add")}


def reset_counts() -> None:
    """Just before a run: its launch counts from 0, and only its own
    block laps in profiling.last_laps()."""
    for k in COUNTERS.values():
        k.launches = 0
    profiling.clear_laps()


def counts() -> dict:
    return {n: k.launches for n, k in COUNTERS.items()}


def require_launched(what: str, launches: dict, names) -> None:
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{what} never launched {missing}")


def log_timer(what: str, totals: dict) -> None:
    for (name, cfg), (calls, ms) in sorted(totals.items(),
                                           key=lambda kv: str(kv[0])):
        log(f"  {what}: {name} cfg {cfg}: {calls} calls, {ms:.1f} ms of "
            f"device time")


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def streamed_msm(rng, n=1 << 16, blk=1 << 14, c=16,
                 chunk=M.DEFAULT_CHUNK) -> None:
    """Phase 5: the streamed MSM against the unstreamed pass."""
    curve = MNT4753
    cops = get_curve_ops(curve, "g1")
    hg, g1 = HE.g1_group(curve), HE.g1_generator(curve)
    base = np.stack([affine_words(hg, hg.mul(3 + 7 * j, g1), 1, curve.fq.p)
                     for j in range(NBASE)])
    rows = torch.from_numpy(base[np.arange(n) % NBASE]).to(DEV)
    rows[::97, 24:] = 0                                  # infinity rows
    keys = torch.from_numpy(rand_canon(rng, curve.fr.p, (n,))).to(DEV)
    seg = (torch.arange(n, device=DEV) >= n // 2).long()
    scans = M.MSM_SCAN.launches
    ws_s = M.msm_window_sums_streamed(cops, keys, rows, chunk, c, seg, 2,
                                      blk, True)
    scans_s = M.MSM_SCAN.launches - scans
    ws_u = M.msm_window_sums(cops, keys, rows, chunk, c, seg, 2, True)
    scans_u = M.MSM_SCAN.launches - scans - scans_s
    torch.cuda.synchronize()
    if scans_s != (n // blk) * scans_u:
        raise AssertionError(f"streamed MSM: {scans_s} scan launches for "
                             f"{n // blk} blocks, {scans_u} unstreamed")
    got, want = ([M.finalize_msm(hg, w, c)
                  for w in M.window_sums_to_host(cops, ws, 2)]
                 for ws in (ws_s, ws_u))
    for i, (a, b) in enumerate(zip(got, want)):
        if hg.is_zero(a) or not hg.equal(a, b):
            raise AssertionError(f"streamed MSM {i} differs from the "
                                 f"unstreamed pass")
    log(f"streamed MSM: {n} points in {n // blk} blocks of {blk}, signed, "
        f"c = {c}, 2 fused MSMs: {scans_s} scan launches, equal to the "
        f"unstreamed pass ({scans_u} scan launches)")


def require_proof(what: str, got, want) -> None:
    for name, g, wv in zip("ABC", got, want):
        if tuple(g) != tuple(wv):
            raise AssertionError(f"{what}: proof {name} disagrees with the "
                                 f"known logs")


class HostPeak:
    """The process's peak resident set while the block runs, sampled from
    /proc/self/status every 20 ms by a thread (getrusage's ru_maxrss is
    the peak of the whole run, not of one phase)."""

    def __enter__(self):
        self.peak, self.done = rss_bytes(), threading.Event()

        def sample():
            while not self.done.wait(0.02):
                self.peak = max(self.peak, rss_bytes())
        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join()
        self.peak = max(self.peak, rss_bytes())


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


class KeepH:
    """Keeps a host copy of the H pipeline's outputs (h_mont, h_std) each
    time models/gpu_prover calls compute_h: the known logs of C are taken
    with the proof's own H, and phase 4 holds it against the plain
    pipeline.  The copy is made inside the H lap (about 0.3 s at 2^24)."""

    def __enter__(self):
        self.saved, self.outs = GP.compute_h, []

        def keep(*args):
            out = self.saved(*args)
            self.outs.append(tuple(t.cpu() for t in out))
            return out
        GP.compute_h = keep
        return self

    def __exit__(self, *exc):
        GP.compute_h = self.saved


H_BLOCK_CHECK = 1 << 14     # column block of phase 4's second H pipeline


def full_proof(curve, log2: int, workdir: str, rng, plain_h: bool = True):
    """One proof through prove_files on synthetic files of a 2^log2
    domain, checked against the known logs with the proof's own H; with
    plain_h, that H also against the plain pipeline on the card on the
    same inputs, and against the pipeline with its add/sub in blocks of
    H_BLOCK_CHECK lanes (the widths of 2^24 and 2^25 in small)."""
    t0 = time.time()
    params, inp, ks, logs, values = write_synthetic(curve, log2, workdir,
                                                    rng)
    files_s = time.time() - t0
    log(f"{curve.name} 2^{log2}: synthetic files written in {files_s:.1f} s")
    out = os.path.join(workdir, f"{curve.name}-output")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.time()
    with KernelTimer(MSM_TARGETS) as timer, \
            Capture(GP, "finalize_windows") as fin, KeepH() as keep_h, \
            HostPeak() as host:
        GP.prove_files(curve, params, inp, out, device=DEV)
    wall = time.time() - t1
    launches = counts()
    in_proof = timer.totals()
    peak = torch.cuda.max_memory_allocated()
    laps = profiling.last_laps()
    log(f"{curve.name} 2^{log2}: prove_files {wall:.2f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB, peak host RSS "
        f"{host.peak / 2**30:.2f} GiB")
    for name, dt in laps.items():
        log(f"  phase {name}: {dt:.3f} s")
    log(f"  launches: {launches}")
    log_timer("in the proof", in_proof)
    require_launched(f"{curve.name} proof", launches, PATH_KERNELS)

    h_k, = keep_h.outs
    want = known_proof(curve, ks, logs, values[0], h_k[1].numpy(), values[4])
    if plain_h:
        dev_in = [torch.from_numpy(a).to(DEV) for a in values[1:4]]
        h_p = compute_h(NttPlan(curve.fr, 1 << log2, DEV,
                                mul=MM.mont_mul_plain), *dev_in)
        require_equal(f"{curve.name} H pipeline", h_k,
                      tuple(t.cpu() for t in h_p))
        # the plain add/sub in many column blocks, as at 2^24 and 2^25
        block, NT.COL_BLOCK = NT.COL_BLOCK, H_BLOCK_CHECK
        try:
            h_b = compute_h(NttPlan(curve.fr, 1 << log2, DEV), *dev_in)
        finally:
            NT.COL_BLOCK = block
        require_equal(f"{curve.name} H pipeline in blocks of "
                      f"{H_BLOCK_CHECK} lanes", h_k,
                      tuple(t.cpu() for t in h_b))
        del h_p, h_b, dev_in
        h_note = ("the proof's H equals the plain pipeline and the one in "
                  f"blocks of {H_BLOCK_CHECK} lanes")
    else:
        h_note = ("the plain H pipeline is left to the 2^20 proof of "
                  "phase 4 (minutes of plain mont_mul at this size)")
    del h_k, keep_h
    require_proof(f"{curve.name} 2^{log2}", read_proof(out, curve), want)
    log(f"{curve.name} 2^{log2}: A, B, C match the known logs (m = "
        f"{1 << log2}); {h_note}")
    return dict(wall_s=wall, peak_bytes=peak, host_peak_bytes=host.peak,
                files_s=files_s, phases=laps, launches=launches,
                in_proof=in_proof, params=params, input=inp, output=out,
                sha=sha256(out), want=want, ks=ks, logs=logs, log2=log2,
                window_sums=fin.calls)


# -- phases 6 to 8: the table path and serving --------------------------------

def normalisation_check(rng, curve, n: int = 300) -> None:
    """to_affine_rows on the card against its plain version and against
    host inversions: multiples k*G scaled by a random Z, every 7th point
    the identity (0 : 1 : 0)."""
    p, alpha = curve.fq.p, curve.non_residue
    for group in ("g1", "g2"):
        cops = get_curve_ops(curve, group)
        deg = cops.deg
        hg = HE.g1_group(curve) if group == "g1" else HE.g2_group(curve)
        gen = HE.g1_generator(curve) if group == "g1" else \
            HE.g2_generator(curve)
        coords = [[] for _ in range(3 * deg)]
        want = []
        for i in range(n):
            if i % 7 == 3:
                X, Y, Z = (0,) * deg, (1,) + (0,) * (deg - 1), (0,) * deg
                want.append(np.zeros(2 * deg * L.NWORDS, np.int32))
            else:
                pt = hg.mul(int(rng.integers(1, 1 << 40)), gen)
                want.append(affine_words(hg, pt, deg, p))
                x, y = hg.to_affine(pt)
                x, y = (x, y) if deg > 1 else ((x,), (y,))
                Z = tuple(int(v) % p for v in rng.integers(1, 1 << 62,
                                                           size=deg))
                X, Y = HF.e_mul(x, Z, p, alpha), HF.e_mul(y, Z, p, alpha)
            for k in range(deg):
                for j, v in enumerate((X, Y, Z)):
                    coords[j * deg + k].append(v[k] * R % p)
        P = torch.from_numpy(np.stack([L.ints_to_words(c)
                                       for c in coords])).to(DEV)
        got = to_affine_rows(cops, P)
        require_equal(f"affine normalisation cfg {cops.cfg}", got,
                      to_affine_rows(cops, P, mul=MM.mont_mul_plain))
        if not np.array_equal(got.cpu().numpy(), np.stack(want)):
            raise AssertionError(f"affine normalisation cfg {cops.cfg} "
                                 f"differs from the host inversion")
        log(f"affine normalisation {curve.name} {group}: {n} points equal "
            f"the plain version and the host inversion")


def mixed_add_path_check(curve, queries, results: dict) -> None:
    """ec_mixed_add at the widths of the table build: the first three
    steps of multiples_rows (identity + P, P + P, 2P + P) on the query's
    own base rows, kernel against plain (lanewise) on the card.  The
    first query of each group configuration is also timed."""
    plain_add = lanewise(GK.ec_mixed_add_plain)
    for name, rows, group in queries:
        cops = get_curve_ops(curve, group)
        xy, inf = PD.affine_operand(cops, rows, DEV)
        n = xy.shape[-1]
        acc = M.identity_words(cops, n, DEV)
        err = 0
        for step in range(3):
            got = GK.ec_mixed_add(cops, acc, xy, inf)
            want, plain = cuda_once(lambda: plain_add(cops, acc, xy, inf))
            err = max(err, require_equal(
                f"ec_mixed_add {curve.name} {name} step {step}", got, want))
            if step < 2:
                acc = got
        del got, want
        r = results["ec_mixed_add", cops.cfg]
        if "path_shape" in r:
            r["path_shape"] += f"; {n} points ({name}), equal"
            log(f"ec_mixed_add {curve.name} {name} n={n}: 3 table-build "
                f"steps equal the plain version")
            continue
        ms = cuda_ms(lambda: GK.ec_mixed_add(cops, acc, xy, inf), 3)
        deg = cops.deg
        bnd, _ = bound_ms(n * FQ_MULS["mixed_add"][deg] * MADS_PER_FQ_MUL,
                          n * 8 * deg * 96)
        log(f"ec_mixed_add {curve.name} {name} n={n}: 3 table-build steps "
            f"equal the plain version; kernel {ms:.3f} ms, plain "
            f"{plain:.1f} ms, bound {bnd:.4f} ms")
        r.update(path_shape=f"{n} points ({name})", path_ms=ms,
                 path_plain_ms=plain, path_bound_ms=bnd,
                 path_max_abs_err=err)


def straus_check(rng, curve, tables, npath: int, results: dict) -> None:
    """straus_window_sums on the first points of the B1 and B2 tables
    (rows of npath points each), as many points as make the tree's first
    level at least as wide as in the npath-point MSM of the proof,
    against the same tree on the plain group add (lanewise) on the
    card."""
    nwin = S.num_windows()
    for group, t in (("g1", tables[0]), ("g2", tables[1])):
        cops = get_curve_ops(curve, group)
        path = S.window_block(cops.deg, npath) * (npath // 2)
        n = min(npath, 2 * -(-path // nwin))
        first = S.window_block(cops.deg, n) * (n // 2)
        t = torch.as_tensor(t)
        sub = t.reshape(31, npath, -1)[:, :n].reshape(31 * n, -1).to(DEV)
        k = rand_canon(rng, curve.fr.p, (n,))
        k[:, 0] = 0
        k[:, 1] = L.int_to_words(curve.fr.p - 1)
        keys = torch.from_numpy(k).to(DEV)
        got = S.straus_window_sums(cops, keys, sub)
        want, plain = cuda_once(lambda: S.straus_window_sums(
            cops, keys, sub, add=lanewise(GK.ec_add_plain)))
        err = require_equal(f"straus_window_sums cfg {cops.cfg}", got, want)
        ms = cuda_ms(lambda: S.straus_window_sums(cops, keys, sub), 3)
        log(f"straus_window_sums {curve.name} {group} n={n} (first level "
            f"{first} lanes, the proof's {path}): kernels {ms:.2f} ms, "
            f"plain {plain:.1f} ms, equal")
        results["ec_add", cops.cfg].update(
            straus_shape=f"{n} points x {nwin} windows, first level "
                         f"{first} lanes (proof {path})",
            straus_ms=ms, straus_plain_ms=plain, straus_max_abs_err=err)
        del sub, keys, got, want


def table_files_phase(rng, run, workdir: str, results: dict) -> dict:
    """Phase 6: preprocess and compute through the CLI at MNT6753 2^15."""
    curve = MNT6753
    params = GP.load_params(run["params"], curve)
    mixed_add_path_check(curve, (("B1", params.B1, "g1"),
                                 ("B2", params.B2, "g2"),
                                 ("L", params.L, "g1")), results)
    del params
    tdir = os.path.join(workdir, "tables")
    os.mkdir(tdir)
    os.chdir(tdir)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with KernelTimer(TABLE_TARGETS) as tb:
            rc = cli.main(["gpu", curve.name, "preprocess", run["params"],
                           "--device", DEV])
            torch.cuda.synchronize()
        build_s = time.time() - t0
        build = counts()
        build_calls = tb.totals()
        table = os.path.abspath(f"{curve.name}_preprocessed")
        size = os.path.getsize(table)
        log(f"{curve.name} 2^{run['log2']} preprocess: {build_s:.2f} s, "
            f"{size / 1e9:.3f} GB, launches {build}")
        log_timer("in the table build", build_calls)
        if rc != 0 or build["ec_mixed_add"] != 93:
            raise AssertionError(f"preprocess rc {rc}, "
                                 f"{build['ec_mixed_add']} mixed adds")
        require_launched("MNT6753 table build", build, BUILD_KERNELS)

        out = os.path.abspath("output-tables")
        reset_counts()
        t1 = time.time()
        with KernelTimer(MSM_TARGETS) as tm, \
                KernelTimer(TABLE_TARGETS) as tt:
            rc = cli.main(["gpu", curve.name, "compute", run["params"],
                           run["input"], out, "--device", DEV])
        wall = time.time() - t1
        launches = counts()
        laps = profiling.last_laps()
        in_proof = {**tm.totals(), **tt.totals()}
        log(f"{curve.name} 2^{run['log2']} compute with tables: {wall:.2f} "
            f"s, launches {launches}")
        for name in ("load preprocessing", MSM_STRAUS):
            if name in laps:
                log(f"  phase {name}: {laps[name]:.3f} s")
        log_timer("in the table proof", in_proof)
        require_launched("MNT6753 table proof", launches, PATH_KERNELS)
        if rc != 0 or sha256(out) != run["sha"]:
            raise AssertionError("MNT6753 table proof sha256 differs from "
                                 "the Pippenger proof")
        require_proof("MNT6753 table proof", read_proof(out, curve),
                      run["want"])
        log(f"{curve.name} table proof: sha256 {run['sha']} equals the "
            f"Pippenger proof; A, B, C match the known logs")

        m = 1 << run["log2"]
        tables = GP.load_preprocessed(table, curve, m, m - 1)
        straus_check(rng, curve, tables, m + 1, results)
        del tables
        os.remove(table)
    finally:
        os.chdir(workdir)
    normalisation_check(rng, curve)
    return dict(build_s=build_s, build=build, build_calls=build_calls,
                wall_s=wall, launches=launches, in_proof=in_proof,
                phases=laps, bytes=size)


def table_memory_phase(rng, run, results: dict) -> dict:
    """Phase 7: tables built on the card, handed to prove(tables=...)."""
    curve = MNT4753
    params = GP.load_params(run["params"], curve)
    inputs = GP.load_input(run["input"], curve, params.d, params.m)
    mixed_add_path_check(curve, (("B1", params.B1, "g1"),
                                 ("B2", params.B2, "g2"),
                                 ("L", params.L, "g1")), results)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with KernelTimer(TABLE_TARGETS) as tb:
        tables = tuple(PD.multiples_rows(curve, group, rows, device=DEV)
                       for rows, group in ((params.B1, "g1"),
                                           (params.B2, "g2"),
                                           (params.L, "g1")))
        torch.cuda.synchronize()
    build_s = time.time() - t0
    build = counts()
    build_calls = tb.totals()
    build_peak = torch.cuda.max_memory_allocated()
    log(f"{curve.name} 2^{run['log2']} table build on the card: "
        f"{build_s:.2f} s, {sum(t.numel() for t in tables) * 4 / 1e9:.2f} GB "
        f"of tables, peak {build_peak / 2**30:.2f} GiB, launches {build}")
    log_timer("in the table build", build_calls)
    require_launched("MNT4753 table build", build, BUILD_KERNELS)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.time()
    with KernelTimer(MSM_TARGETS) as tm, KernelTimer(TABLE_TARGETS) as tt:
        proof = GP.prove(curve, params, inputs, device=DEV, tables=tables)
    wall = time.time() - t1
    launches = counts()
    in_proof = {**tm.totals(), **tt.totals()}
    peak = torch.cuda.max_memory_allocated()
    laps = profiling.last_laps()
    log(f"{curve.name} 2^{run['log2']} prove with device tables: "
        f"{wall:.2f} s, peak device memory {peak / 2**30:.2f} GiB")
    for name in ("stage params (host->device)", "stage inputs (host->device)",
                 "H pipeline (device NTT)", "scalar from_monty (device)",
                 MSM_STRAUS, "readback + host assembly"):
        log(f"  phase {name}: {laps[name]:.3f} s")
    log(f"  launches: {launches}")
    log_timer("in the table proof", in_proof)
    require_launched("MNT4753 table proof", launches, PATH_KERNELS)
    require_proof("MNT4753 2^20 table proof", proof, run["want"])
    log(f"{curve.name} 2^{run['log2']} table proof: A, B, C match the known "
        f"logs")
    straus_check(rng, curve, tables, params.m + 1, results)
    del tables
    torch.cuda.empty_cache()
    return dict(build_s=build_s, build=build, build_calls=build_calls,
                build_peak=build_peak, wall_s=wall, launches=launches,
                in_proof=in_proof, peak_bytes=peak, phases=laps)


def serve_phase(rng, run, workdir: str) -> dict:
    """Phase 8: `gpu MNT4753 serve` with two inputs at 2^20."""
    curve = MNT4753
    fresh = os.path.join(workdir, f"{curve.name}-input-2")
    values = write_input(curve, run["log2"], fresh, rng)
    want2 = expected_proof(curve, run["log2"], run["ks"], run["logs"],
                           values, DEV)
    outs = [os.path.join(workdir, f"serve-output-{i}") for i in (0, 1)]
    reset_counts()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["gpu", curve.name, "serve", run["params"],
                       run["input"], outs[0], fresh, outs[1],
                       "--device", DEV])
    wall = time.time() - t0
    launches = counts()
    text = buf.getvalue()
    log(text.rstrip())
    laps = {k: float(v) for k, v in
            re.findall(r"^(.+): ([0-9.]+)s$", text, re.M)}
    log(f"{curve.name} serve, 2 inputs: {wall:.2f} s, launches {launches}")
    if rc != 0 or text.count("stage params:") != 1:
        raise AssertionError("serve must stage the parameters once")
    require_launched("MNT4753 serve", launches, PATH_KERNELS)
    if sha256(outs[0]) != run["sha"]:
        raise AssertionError("served proof 0 differs from the one-shot "
                             "proof of the same pair")
    require_proof("served proof 0", read_proof(outs[0], curve), run["want"])
    require_proof("served proof 1", read_proof(outs[1], curve), want2)
    log(f"{curve.name} serve: both proofs match their known logs; proof 0 "
        f"equals the one-shot proof")
    return dict(wall_s=wall, laps=laps, launches=launches)


# -- phase 9: setup and the cpu oracle ---------------------------------------

def native_epilogue_check(runs) -> None:
    """9a: the native Horner epilogue against finalize_msm on the window
    sums of the phase-4 proofs (every finalize_windows call of each)."""
    if not native.available():
        raise AssertionError("the native host library did not build")
    for run in runs:
        for cops, hg, ws, cbits, *num in run["window_sums"]:
            num = num[0] if num else 1
            t0 = time.time()
            got = M.finalize_windows_native(cops, hg, ws, cbits, num)
            t1 = time.time()
            want = [M.finalize_msm(hg, pts, cbits)
                    for pts in M.window_sums_to_host(cops, ws, num)]
            t2 = time.time()
            if len(got) != num or not all(hg.equal(a, b)
                                          for a, b in zip(got, want)):
                raise AssertionError(f"native epilogue cfg {cops.cfg} "
                                     f"differs from finalize_msm")
            log(f"native epilogue cfg {cops.cfg}, {num} MSMs x "
                f"{ws.shape[-1] // num} windows of {cbits} bits: "
                f"{(t1 - t0) * 1e3:.1f} ms, finalize_msm "
                f"{(t2 - t1) * 1e3:.1f} ms, equal")


def host_multiples(curve, group, base, scalars, idx) -> np.ndarray:
    hg = SD.host_group(curve, group)
    deg = 1 if group == "g1" else curve.ext_degree
    return SD.affine_rows(curve, deg, [hg.to_affine(hg.mul(scalars[i], base))
                                       for i in idx])


def edge_scalars(rng, curve, n: int) -> list:
    """n scalars below r from words, the first three 0, 1 and r - 1."""
    r = curve.fr.p
    sc = L.words_to_ints(rand_canon(rng, r, (n,)))
    sc[:3] = [0, 1, r - 1]
    return sc


def setup_kernel_check(name: str, captured, label: str,
                       results: dict) -> None:
    """One group kernel on operands the setup gave it: the kernel at the
    full width against the plain version on the first lanes (lanewise),
    timed against its bound."""
    op = {"ec_add": "add", "ec_dbl": "dbl", "ec_mixed_add": "mixed_add"}[name]
    ncoords = {"add": 9, "dbl": 6, "mixed_add": 8}[op]
    cops, *ops = captured
    n = ops[0].shape[-1]
    kern = getattr(GK, name)
    plain_fn = lanewise(getattr(GK, name + "_plain"))
    sl = min(n, 1 << 12)
    got = kern(cops, *ops)
    want, plain = cuda_once(lambda: plain_fn(
        cops, *(t[..., :sl].contiguous() for t in ops)))
    err = require_equal(f"{name} cfg {cops.cfg} ({label})", got[..., :sl],
                        want)
    ms = cuda_ms(lambda: kern(cops, *ops), 3)
    deg = cops.deg
    bnd, by = bound_ms(n * FQ_MULS[op][deg] * MADS_PER_FQ_MUL,
                       n * ncoords * deg * 96)
    log(f"{name} cfg {cops.cfg} at {label}, n={n}: kernel {ms:.3f} ms, "
        f"bound {bnd:.4f} ms ({by}); plain on {sl} lanes {plain:.1f} ms, "
        f"equal")
    results.setdefault((name, cops.cfg), {}).update(
        setup_shape=f"{n} points ({label}; plain on {sl} lanes)",
        setup_ms=ms, setup_plain_ms=plain, setup_bound_ms=bnd,
        setup_bound_by=by, setup_max_abs_err=err)


def files_equal(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def setup_oracle_phase(rng, workdir: str, results: dict, log2: int = 6,
                       nscan: int = 33) -> dict:
    """9b: the CLI's host-oracle files against the device setup, both
    curves; `cpu compute` against `gpu compute` on them; the scan path."""
    cdir, odir, ddir = (os.path.join(workdir, f"setup{log2}-{k}")
                        for k in ("cli", "oracle", "device"))
    for d in (cdir, odir, ddir):
        os.mkdir(d)
    t0 = time.time()
    rc = cli.main(["generate_parameters", "--log2-d-4753", str(log2),
                   "--log2-d-6753", str(log2), "--seed", str(SETUP_SEED),
                   "--outdir", cdir, "--device", DEV])
    log(f"generate_parameters (CLI, host oracle) at 2^{log2}: "
        f"{time.time() - t0:.1f} s")
    if rc != 0:
        raise AssertionError("generate_parameters failed")
    launches = {}
    for curve in (MNT4753, MNT6753):
        name = curve.name
        paths = {}
        for d, oracle in ((odir, True), (ddir, False)):
            paths[d] = [os.path.join(d, f"{name}-{k}")
                        for k in ("parameters", "input", "trapdoor")]
            reset_counts()
            t1 = time.time()
            SU.generate_parameters(curve, log2, *paths[d][:2],
                                   seed=SETUP_SEED,
                                   trapdoor_path=paths[d][2],
                                   device=DEV, oracle=oracle)
            if not oracle:
                torch.cuda.synchronize()
                launches[name] = counts()
            kind = "host oracle" if oracle else "device"
            log(f"{name} 2^{log2} setup ({kind}): {time.time() - t1:.1f} s")
        require_launched(f"{name} device setup", launches[name],
                         SETUP_KERNELS)
        for k, kind in enumerate(("parameters", "input")):
            cli_file = os.path.join(cdir, f"{name}-{kind}")
            if not (files_equal(cli_file, paths[odir][k])
                    and files_equal(cli_file, paths[ddir][k])):
                raise AssertionError(f"{name} {kind}: the device setup "
                                     f"differs from the host oracle")
        if not files_equal(paths[odir][2], paths[ddir][2]):
            raise AssertionError(f"{name} trapdoor differs")
        outs = {}
        for mode in ("cpu", "gpu"):
            outs[mode] = os.path.join(workdir, f"{name}-{log2}-{mode}")
            argv = [mode, name, "compute", *paths[ddir][:2], outs[mode]]
            t1 = time.time()
            if cli.main(argv + (["--device", DEV] if mode == "gpu"
                                else [])) != 0:
                raise AssertionError(f"{mode} compute failed")
            log(f"{name} 2^{log2} {mode} compute: {time.time() - t1:.1f} s")
        if sha256(outs["cpu"]) != sha256(outs["gpu"]):
            raise AssertionError(f"{name}: gpu compute differs from cpu "
                                 f"compute on generated files")
        log(f"{name} 2^{log2}: device setup = host oracle (parameters, "
            f"input, trapdoor); cpu and gpu proofs sha256 "
            f"{sha256(outs['gpu'])}; launches {launches[name]}")

    # the scan path: double and add, the only ec_dbl of the setup
    os.environ["GROTH16_EXP_WINDOWED"] = "0"
    try:
        for group in ("g1", "g2"):
            curve = MNT4753
            hg = SD.host_group(curve, group)
            gen = HE.g1_generator(curve) if group == "g1" else \
                HE.g2_generator(curve)
            base = hg.mul(int(rng.integers(2, 1 << 62)), gen)
            sc = edge_scalars(rng, curve, nscan)
            reset_counts()
            t1 = time.time()
            with Capture(GK, "ec_dbl", index=L.R_BITS // 2) as cap:
                rows = SD.batch_exp_device(curve, group, base, sc, DEV)
            torch.cuda.synchronize()
            dt = time.time() - t1
            got = counts()
            require_launched(f"scan path {group}", got, SCAN_KERNELS)
            if not np.array_equal(rows, host_multiples(curve, group, base,
                                                       sc, range(nscan))):
                raise AssertionError(f"scan path {group} differs from host "
                                     f"multiples")
            log(f"batch_exp_device scan path MNT4753 {group}, n={nscan}: "
                f"{dt:.2f} s, launches {got}, equal to host multiples")
            launches[f"scan {group}"] = got
            setup_kernel_check("ec_dbl", cap.calls[0],
                               "setup scan path", results)
    finally:
        os.environ.pop("GROTH16_EXP_WINDOWED", None)
    return launches


SETUP_LAPS = ("setup host part (R1CS, QAP, scalar vectors)",
              "batch_exp A (device)", "batch_exp B1 (device)",
              "batch_exp B2 (device)", "batch_exp L (device)",
              "batch_exp H (device)", "write files")


def setup_full_phase(workdir: str, results: dict,
                     sizes=((MNT4753, 16), (MNT6753, 15))) -> dict:
    """9c: real keys at working size, proved and verified."""
    out = {}
    for curve, log2 in sizes:
        name = curve.name
        d = os.path.join(workdir, f"keys-{name}")
        os.mkdir(d)
        params, inp, td, proof = (os.path.join(d, k) for k in (
            "parameters", "input", "trapdoor.json", "output"))
        # a cold setup: the window tables of 9b (same seed, so the same
        # g1 base, and the fixed G2 generator) are built again
        SD._TABLE_CACHE.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ladder = lambda a: a[1].shape[-1] == SD.NWIN  # noqa: E731
        t0 = time.time()
        with KernelTimer({"to_affine_rows": (SD, "to_affine_rows")}) as ta, \
                Capture(GK, "ec_mixed_add", ladder, 128) as mix, \
                Capture(GK, "ec_add", lambda a: a[1].shape[-1] > SD.NWIN,
                        SD.NWIN // 2) as add:
            SU.generate_parameters(curve, log2, params, inp, seed=SETUP_SEED,
                                   trapdoor_path=td, device=DEV)
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        laps = {k: v for k, v in profiling.last_laps().items()
                if k in SETUP_LAPS}
        affine = ta.totals()
        log(f"{name} 2^{log2} generate_parameters on the card: {wall:.2f} s, "
            f"peak device memory {peak / 2**30:.2f} GiB, launches "
            f"{launches}")
        for k in SETUP_LAPS:
            log(f"  phase {k}: {laps[k]:.3f} s")
        log_timer("affine rows", affine)
        require_launched(f"{name} setup", launches, SETUP_KERNELS)
        for cap, kname in ((mix, "ec_mixed_add"), (add, "ec_add")):
            for args in cap.calls:
                setup_kernel_check(kname, args, f"setup {name} 2^{log2}",
                                   results)
        del mix, add
        t1 = time.time()
        if cli.main(["gpu", name, "compute", params, inp, proof,
                     "--device", DEV]) != 0:
            raise AssertionError(f"{name} proof failed")
        prove_s = time.time() - t1
        t1 = time.time()
        ok = HG.verify_with_trapdoor(curve,
                                     SU.trapdoor_result(curve, td, inp),
                                     *read_proof(proof, curve))
        verify_s = time.time() - t1
        if not ok:
            raise AssertionError(f"{name} 2^{log2}: the proof from generated "
                                 f"keys fails verify_with_trapdoor")
        log(f"{name} 2^{log2}: gpu compute {prove_s:.2f} s; A, B, C pass "
            f"verify_with_trapdoor ({verify_s:.1f} s)")
        out[name] = dict(wall_s=wall, laps=laps, launches=launches,
                         peak_bytes=peak, affine=affine, log2=log2)
        os.remove(td)
    return out


def batch_exp_full_phase(rng, results: dict, n: int = 1 << 20,
                         nsample: int = 256) -> dict:
    """9d: batch_exp_device at MNT4753's 2^20 query size, G1 and Fq2."""
    curve = MNT4753
    sc = edge_scalars(rng, curve, n)
    idx = sorted({0, 1, 2, *(int(i) for i in rng.choice(n, nsample - 3,
                                                         replace=False))})
    out = {}
    for group in ("g1", "g2"):
        hg = SD.host_group(curve, group)
        gen = HE.g1_generator(curve) if group == "g1" else \
            HE.g2_generator(curve)
        base = hg.mul(int(rng.integers(2, 1 << 62)), gen)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        with KernelTimer({"to_affine_rows": (SD, "to_affine_rows")}) as ta, \
                Capture(GK, "ec_add", lambda a: a[1].shape[-1] == n,
                        SD.NWIN // 2) as add:
            rows = SD.batch_exp_device(curve, group, base, sc, DEV)
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        affine = ta.totals()
        if launches["ec_mixed_add"] != 255 or launches["ec_add"] != SD.NWIN:
            raise AssertionError(f"batch_exp {group}: launches {launches}")
        if not np.array_equal(rows[idx], host_multiples(curve, group, base,
                                                        sc, idx)):
            raise AssertionError(f"batch_exp {group} at 2^20 differs from "
                                 f"host multiples")
        log(f"batch_exp_device MNT4753 {group} n={n}: {wall:.2f} s, peak "
            f"device memory {peak / 2**30:.2f} GiB, launches {launches}; "
            f"{len(idx)} sampled lanes equal host multiples")
        log_timer("affine rows", affine)
        setup_kernel_check("ec_add", add.calls[0],
                           f"batch_exp 2^{n.bit_length() - 1} step",
                           results)
        del add, rows
        out[group] = dict(wall_s=wall, launches=launches, peak_bytes=peak,
                          affine=affine)
    SD._TABLE_CACHE.clear()
    torch.cuda.empty_cache()
    return out


# -- phase 10: the multi-device prover -----------------------------------------

RANK_TIMEOUT = 600.0       # seconds for one launch of ranks
STREAM10 = (1 << 16, 1 << 14, 16)   # 10c: points, global block, window bits
NTT10_LOG2 = 20                     # 10d: log2 of the NTT size


class CollectiveTimer:
    """Host clock around each exchange of parallel/sharded.Comm, with the
    card drained before and after, so a sum is the exchange alone (on
    gloo its staging copies through host memory included): name ->
    [calls, seconds]."""

    NAMES = ("all_to_all", "all_gather")

    def __enter__(self):
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
            setattr(SH.Comm, name, fn)


def first_of_shape(min_lanes: int):
    """A Capture filter: the first mont_mul call of each operand shape
    with at least min_lanes lanes."""
    seen = set()

    def keep(args):
        shape = tuple(args[1].shape)
        if args[1][0].numel() < min_lanes or shape in seen:
            return False
        seen.add(shape)
        return True
    return keep


def captured_scan_check(args, label: str) -> dict:
    """The bucket scan on the operands a run gave it, against its plain
    version on the card: the plain side on PLAIN_CHUNKS of its chunks,
    spread over its windows."""
    cops, rows, idx, keys, signs = args
    S, B = idx.shape
    cols = torch.arange(0, B, max(1, B // PLAIN_CHUNKS),
                        device=idx.device)[:PLAIN_CHUNKS]
    sub = [None if t is None else t[:, cols].contiguous()
           for t in (idx, keys, signs)]
    got, ms = cuda_once(lambda: M.msm_scan(cops, rows, idx, keys, signs))
    want, plain = cuda_once(lambda: M.msm_scan_plain(cops, rows, *sub))
    cfg_name = config_name(cops)
    shape = f"S={S}, B={B}, plain on {len(cols)} chunks"
    err = require_equal(f"msm_scan {cfg_name} ({label}, {shape})",
                        [g[..., cols] for g in got], want)
    return dict(name="msm_scan", config=cfg_name, shape=shape,
                max_abs_err=err, ms=ms, plain_ms=plain)


def sharded_path_checks(caps: dict, label: str) -> list:
    """The kernels on the operands a rank's prove_sharded gave them,
    against their plain versions on the card: the first bucket scan of
    each MSM (plain on PLAIN_CHUNKS of its chunks, spread over its
    windows), the cross-rank combine's ec_add and the NTT's mont_mul
    calls of each shape (full width)."""
    out = []

    def add(name, cfg_name, shape, got, want, ms, plain):
        err = require_equal(f"{name} {cfg_name} ({label}, {shape})", got,
                            want)
        out.append(dict(name=name, config=cfg_name, shape=shape,
                        max_abs_err=err, ms=ms, plain_ms=plain))

    for args in caps["msm_scan"].calls:
        out.append(captured_scan_check(args, label))
    for cops, P, Q in caps["ec_add"].calls:
        got, ms = cuda_once(lambda: GK.ec_add(cops, P, Q))
        want, plain = cuda_once(lambda: GK.ec_add_plain(cops, P, Q))
        add("ec_add", config_name(cops),
            f"{P.shape[-1]} points (cross-rank combine)", got, want, ms,
            plain)
    for ctx, a, b in caps["mont_mul"].calls:
        got, ms = cuda_once(lambda: MM.mont_mul(ctx, a, b))
        want, plain = cuda_once(lambda: MM.mont_mul_plain(ctx, a, b))
        add("mont_mul", f"prime {ctx.prime_id}", str(tuple(a.shape)), got,
            want, ms, plain)
    return out


def _rank_proof(rank, curve_name, params_path, input_path,
                check=False, **options) -> dict:
    """prove_sharded in a rank on a parameter / input file pair (options:
    its block_points and resident_bytes), with its laps, peak memory,
    collectives, uploads of host rows, launches and op tally.  With
    check, a second proof captures the kernels' operands, which are then
    held against their plain versions (sharded_path_checks): the first
    run's numbers stay those of the entry point alone."""
    curve = {"MNT4753": MNT4753, "MNT6753": MNT6753}[curve_name]
    params = GP.load_params(params_path, curve)
    inputs = GP.load_input(input_path, curve, params.d, params.m)
    world = torch.distributed.get_world_size()
    if world > 1:
        # start together: a rank still checking the previous proof would
        # count in the other's first exchange
        torch.distributed.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with CollectiveTimer() as coll, UploadTimer() as uploads, \
            opcount.collect() as tally:
        proof = prove_sharded(curve, params, inputs, device=DEV,
                              verbose=True, **options)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    laps = profiling.last_laps()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "proof")
        SER.write_output(out, curve, *proof)
        sha = sha256(out)
    checks, wall2 = [], None
    if check:
        caps = {"msm_scan": Capture(M, "msm_scan", index=0),
                "ec_add": Capture(SH, "ec_add", index=0),
                "mont_mul": Capture(SH, "mont_mul", keep=first_of_shape(
                    (params.d + 1) // world // 2))}
        t1 = time.time()
        with caps["msm_scan"], caps["ec_add"], caps["mont_mul"]:
            again = prove_sharded(curve, params, inputs, device=DEV)
            torch.cuda.synchronize()
        wall2 = time.time() - t1
        if again != proof:
            raise AssertionError(f"{curve_name} rank {rank}: a second "
                                 f"proof differs from the first")
        checks = sharded_path_checks(caps, f"rank {rank}/{world}")
        got = {k["name"] for k in checks}
        if got != {"msm_scan", "ec_add", "mont_mul"}:
            raise AssertionError(f"{curve_name} rank {rank}: path checks "
                                 f"of {sorted(got)} only")
        del caps
        torch.cuda.empty_cache()
    return dict(rank=rank, curve=curve_name, wall_s=wall, sha=sha,
                proof=proof, laps=laps, peak_bytes=peak, launches=launches,
                tally=tally, collectives=coll.calls, checks=checks,
                wall2_s=wall2, uploads=uploads.totals())


def rank_world1(rank, files4) -> dict:
    """10a: one rank on nccl, the MNT4753 2^20 proof."""
    return _rank_proof(rank, "MNT4753", *files4)


def streamed_inputs(n: int):
    """10c's points (64 known multiples tiled, every 97th at infinity)
    and scalars, the same in every rank."""
    curve = MNT4753
    hg, g1 = HE.g1_group(curve), HE.g1_generator(curve)
    base = np.stack([affine_words(hg, hg.mul(3 + 7 * j, g1), 1, curve.fq.p)
                     for j in range(NBASE)])
    rows = base[np.arange(n) % NBASE]
    rows[::97, 24:] = 0
    keys = rand_canon(np.random.default_rng(SEED + 10), curve.fr.p, (n,))
    return rows, keys


def rank_streamed(rank) -> dict:
    """10c: the sharded MSM of n MNT4753 G1 points (two fused MSMs,
    signed digits of c bits) in global blocks of blk points and in one
    pass (n, blk, c = STREAM10)."""
    n, blk, c = STREAM10
    cops = get_curve_ops(MNT4753, "g1")
    rows, keys = streamed_inputs(n)
    world = torch.distributed.get_world_size()
    per = n // world
    sl = slice(rank * per, (rank + 1) * per)
    rows_t = torch.from_numpy(np.ascontiguousarray(rows[sl])).to(DEV)
    keys_t = torch.from_numpy(np.ascontiguousarray(keys[:, sl])).to(DEV)
    seg = (torch.arange(rank * per, (rank + 1) * per, device=DEV) % 2)
    out = {}
    for name, block in (("streamed", blk), ("one pass", None)):
        scans = M.MSM_SCAN.launches
        ws = SH.sharded_msm_window_sums(cops, keys_t, rows_t,
                                        M.DEFAULT_CHUNK, c, seg, 2, True,
                                        block_points=block)
        out[name] = (ws.cpu().numpy(), M.MSM_SCAN.launches - scans)
    return out


def rank_ntt(rank) -> dict:
    """10d: this rank's shard of sharded_ntt of a random 2^NTT10_LOG2
    vector over Fr, forward and inverse: sha256 of the words and device
    ms."""
    fr = MNT4753.fr
    n = 1 << NTT10_LOG2
    world = torch.distributed.get_world_size()
    x = rand_canon(np.random.default_rng(SEED + 11), fr.p, (n,))
    nl = n // world
    xl = torch.from_numpy(np.ascontiguousarray(
        x[:, rank * nl:(rank + 1) * nl])).to(DEV)
    plan = SH.ShardedNttPlan(fr, n, world, rank, DEV)
    out = {}
    for inverse in (False, True):
        y, ms = cuda_once(lambda: SH.sharded_ntt(plan, xl, inverse))
        out[inverse] = (hashlib.sha256(y.cpu().numpy().tobytes())
                        .hexdigest(), ms)
    return out


def rank_world2(rank, files4, files6) -> dict:
    """10b-10d in one launch of two gloo ranks on the one card."""
    return dict(mnt4753=_rank_proof(rank, "MNT4753", *files4, check=True),
                mnt6753=_rank_proof(rank, "MNT6753", *files6, check=True),
                streamed=rank_streamed(rank), ntt=rank_ntt(rank))


def log_rank(what: str, r: dict) -> None:
    coll = ", ".join(f"{k} {c} calls {s:.3f} s" for k, (c, s) in
                     r["collectives"].items())
    log(f"{what} rank {r['rank']}: prove_sharded {r['wall_s']:.2f} s, peak "
        f"device memory {r['peak_bytes'] / 2**30:.2f} GiB; collectives "
        f"{coll}")
    for name, dt in r["laps"].items():
        if name.startswith(("stage", "H pipeline (sharded", "scalar",
                            "MSMs (points", "readback")):
            log(f"  phase {name}: {dt:.3f} s")
    if r["wall2_s"] is not None:
        log(f"  second proof (no collective timer, operands captured): "
            f"{r['wall2_s']:.2f} s")
    log(f"  launches: {r['launches']}")
    log("  " + opcount.report(r["tally"]).replace("\n", "\n  "))


def scan_half(what: str, one: dict, r: dict, m: int) -> None:
    """A rank's scan point-steps are half of the one-rank run's, up to
    the chunk padding of its two passes and a few rows of the uneven
    witness split, in each of the 768 / c windows."""
    chunk, c, _ = GP.resolve_msm_cfg(m // 2 + 1, torch.device(DEV))
    slack = (768 // c) * 2 * (chunk + 4)
    got, full = r["tally"]["msm_scan_step"], one["tally"]["msm_scan_step"]
    if abs(got - full / 2) > slack:
        raise AssertionError(f"{what} rank {r['rank']}: {got} scan "
                             f"point-steps against {full} for one rank")
    log(f"{what} rank {r['rank']}: {got} scan point-steps, one rank "
        f"{full} (half {full / 2:.0f}, slack {slack})")


def sharded_phase(run4, run6) -> dict:
    """Phase 10: prove_sharded at world 1 on nccl and at world 2 on gloo
    (both ranks on the one card: nccl refuses two ranks on one card), the
    streamed sharded MSM and the sharded NTT."""
    torch.cuda.empty_cache()
    files4, files6 = ((r["params"], r["input"]) for r in (run4, run6))
    t0 = time.time()
    w1, = multihost.launch_local(rank_world1, 1, (files4,), backend="nccl",
                                 timeout=RANK_TIMEOUT)
    log(f"10a: world 1 (nccl) launch {time.time() - t0:.1f} s")
    log_rank(f"10a MNT4753 2^{run4['log2']} world 1", w1)
    require_launched("10a prove_sharded", w1["launches"], PATH_KERNELS)
    if w1["sha"] != run4["sha"]:
        raise AssertionError("10a: the world-1 proof differs from phase 4's")
    require_proof("10a", w1["proof"], run4["want"])
    log(f"10a: sha256 {w1['sha']} equals phase 4's; A, B, C match the "
        f"known logs")

    t1 = time.time()
    w2 = multihost.launch_local(rank_world2, 2, (files4, files6),
                                backend="gloo", timeout=RANK_TIMEOUT)
    log(f"10b-10d: world 2 (gloo, one card) launch {time.time() - t1:.1f} s")
    for r in w2:
        for key, run in (("mnt4753", run4), ("mnt6753", run6)):
            p = r[key]
            log_rank(f"10b {p['curve']} 2^{run['log2']} world 2", p)
            require_launched(f"10b {key} rank {p['rank']}", p["launches"],
                             PATH_KERNELS)
            if p["sha"] != run["sha"]:
                raise AssertionError(f"10b {key} rank {p['rank']}: the "
                                     f"proof differs from phase 4's")
        scan_half(f"10b MNT4753 2^{run4['log2']}", w1, r["mnt4753"],
                  1 << run4["log2"])
        for key in ("mnt4753", "mnt6753"):
            for k in r[key]["checks"]:
                log(f"10b {r[key]['curve']} rank {r[key]['rank']}: "
                    f"{k['name']} "
                    f"{k['config']} at {k['shape']}: kernel {k['ms']:.3f} "
                    f"ms, plain {k['plain_ms']:.1f} ms, equal")
    log("10b: every rank's proof equals phase 4's (MNT4753 2^20, MNT6753 "
        "2^15)")

    hg = HE.g1_group(MNT4753)
    cops = get_curve_ops(MNT4753, "g1")
    got = {}
    for name in ("streamed", "one pass"):
        sums = [r["streamed"][name][0] for r in w2]
        if not all(np.array_equal(s, sums[0]) for s in sums):
            raise AssertionError(f"10c {name}: the ranks' sums differ")
        got[name] = [M.finalize_msm(hg, pts, STREAM10[2]) for pts in
                     M.window_sums_to_host(cops, torch.from_numpy(sums[0]),
                                           2)]
    for i, (a, b) in enumerate(zip(got["streamed"], got["one pass"])):
        if hg.is_zero(a) or not hg.equal(a, b):
            raise AssertionError(f"10c MSM {i}: streamed differs")
    scans = [(r["streamed"]["streamed"][1], r["streamed"]["one pass"][1])
             for r in w2]
    if any(s != STREAM10[0] // STREAM10[1] * u for s, u in scans):
        raise AssertionError(f"10c: scan launches {scans}")
    log(f"10c: {STREAM10[0]} points over 2 ranks in global blocks of "
        f"{STREAM10[1]} equal "
        f"the one pass; scan launches per rank (streamed, one pass) "
        f"{scans}")

    fr = MNT4753.fr
    n = 1 << NTT10_LOG2
    x = torch.from_numpy(rand_canon(np.random.default_rng(SEED + 11),
                                    fr.p, (n,))).to(DEV)
    plan = NttPlan(fr, n, DEV)
    for inverse, fn in ((False, lambda: ntt(plan, x, plan.tw_fwd)),
                        (True, lambda: intt(plan, x))):
        y, ms = cuda_once(fn)
        y = y.cpu().numpy()
        want = [hashlib.sha256(np.ascontiguousarray(
            y[:, k * n // 2:(k + 1) * n // 2]).tobytes()).hexdigest()
            for k in range(2)]
        shards = [r["ntt"][inverse] for r in w2]
        if [s[0] for s in shards] != want:
            raise AssertionError(f"10d: sharded NTT (inverse={inverse}) "
                                 f"differs from ops/ntt on one rank")
        log(f"10d: sharded NTT 2^{NTT10_LOG2} over 2 ranks, "
            f"inverse={inverse}: equal "
            f"word for word; ranks {[round(s[1], 2) for s in shards]} ms, "
            f"one rank {ms:.2f} ms")
    del x, plan
    torch.cuda.empty_cache()
    return dict(world1=w1, world2=w2)


# -- phase 11: streamed and host-resident query rows ------------------------

STREAM11_LOG2 = 24           # 11a: MNT4753 d + 1 = 2^24, rows resident
HOST11_BLOCK = 1 << 19       # 11b: points per block in both sessions
SHARDED11_BLOCK = 1 << 16    # 11c: global block of the MNT6753 proof
HOST11D_LOG2 = 25            # 11d: MNT4753 d + 1 = 2^25, rows on the host
MSM_LAP = "MSMs (device Pippenger)"


def scans_per_pass(points: int, chunk: int, c: int) -> int:
    """Scan launches of one msm_window_sums pass over `points` points:
    768 / c windows, as many a launch as ops/msm.py fits."""
    nwin = 768 // c
    wb = M._fit_block(nwin, min(max(1, M.SCAN_LANES // (points // chunk)),
                                max(1, M.SCAN_POINTS // points)))
    return nwin // wb


def default_blocks(log2: int) -> dict:
    """Per group configuration of an unforced MNT4753 proof at d + 1 =
    2^log2: (blocks, points a block, scan launches), the blocks of
    STREAM_BLOCK points that ops/msm.block_grid cuts."""
    d1 = 1 << log2
    n_g1 = 2 * (d1 + 1) + (d1 - 1) + (d1 - 1)
    chunk, c, _ = GP.resolve_msm_cfg(d1, torch.device(DEV))
    out = {}
    for cfg, n in ((0, n_g1), (1, d1 + 1)):
        nblk, per = M.block_grid(GP.round_up(n, chunk), chunk,
                                 GP.STREAM_BLOCK)
        out[cfg] = (nblk, per, nblk * scans_per_pass(per, chunk, c))
    return out


def check_blocks(what: str, in_proof: dict, blocks: dict) -> None:
    for cfg, (nblk, per, want) in blocks.items():
        got = in_proof.get(("msm_scan", cfg), (0, 0.0))[0]
        if got != want:
            raise AssertionError(f"{what}: {got} scan launches in cfg {cfg}, "
                                 f"want {nblk} blocks x {want // nblk}")
        log(f"{what}: cfg {cfg}: {nblk} blocks of {per} points, {got} scan "
            f"launches ({want // nblk} a block)")


def streamed_default_phase(workdir: str, rng) -> dict:
    """11a: an MNT4753 proof at d + 1 = 2^24 through prove_files with no
    forcing: its 19.3 GB of rows stay on the card (under 3/8 of it), the
    2^26 G1 rows go in 32 blocks of STREAM_BLOCK and the 2^24 + 1 B2 rows
    in 9, A, B and C equal the known logs."""
    curve, log2 = MNT4753, STREAM11_LOG2
    blocks = default_blocks(log2)
    if blocks[0][0] != 32:
        raise AssertionError(f"11a: the G1 rows would go in {blocks[0][0]} "
                             f"blocks, not 32")
    sessions = []
    init = GP.ProverSession.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        sessions.append(self.resident)
    # a directory of its own: phase 4's files of the same names are read
    # again in 11b
    sub = os.path.join(workdir, f"2p{log2}")
    os.makedirs(sub)
    GP.ProverSession.__init__ = keep
    try:
        run = full_proof(curve, log2, sub, rng, plain_h=False)
    finally:
        GP.ProverSession.__init__ = init
    if sessions != [True]:
        raise AssertionError(f"11a: the session's rows are not resident "
                             f"({sessions})")
    check_blocks("11a", run["in_proof"], blocks)
    total = torch.cuda.get_device_properties(0).total_memory
    spare = total - run["peak_bytes"]
    log(f"11a: rows resident (3/8 of the card's {total / 2**30:.2f} GiB "
        f"allows {total * 3 // 8 / 2**30:.2f}); peak device memory "
        f"{run['peak_bytes'] / 2**30:.2f} GiB, {spare / 2**30:.2f} GiB to "
        f"spare; synthetic files {run['files_s']:.1f} s")
    shutil.rmtree(sub)
    del run["window_sums"]
    return run


def host_resident_phase(run4) -> dict:
    """11b: phase 4's MNT4753 2^20 files through two sessions with blocks
    of HOST11_BLOCK points: rows resident, and rows in host memory
    (resident_bytes = 0).  Both proofs have phase 4's sha256; the host
    session's peak device memory is at least half the rows' bytes below
    the resident one's; the copy stream's uploads are timed beside each
    MSM lap.  A second host-resident proof captures the operands of the
    first scan of each MSM, held against the plain scan."""
    curve = MNT4753
    params = GP.load_params(run4["params"], curve)
    inputs = GP.load_input(run4["input"], curve, params.d, params.m)
    out = {}

    def proof_sha(proof) -> str:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "proof")
            SER.write_output(path, curve, *proof)
            return sha256(path)

    for name, opts in (("resident", {}), ("host", {"resident_bytes": 0})):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        with UploadTimer() as uploads:
            sess = GP.ProverSession(curve, params, DEV,
                                    block_points=HOST11_BLOCK, **opts)
            proof = sess.prove(inputs)
            torch.cuda.synchronize()
        wall = time.time() - t0
        r = dict(wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(),
                 launches=counts(), laps=profiling.last_laps(),
                 uploads=uploads.totals(), resident=sess.resident,
                 row_bytes=4 * (sess.n_pad * sess.g1_rows.shape[1]
                                + sess.n2_pad * sess.b2_rows.shape[1]))
        if r["resident"] != (name == "resident"):
            raise AssertionError(f"11b {name}: resident={sess.resident}")
        if proof_sha(proof) != run4["sha"]:
            raise AssertionError(f"11b {name}: the proof differs from "
                                 f"phase 4's")
        require_launched(f"11b {name}", r["launches"], PATH_KERNELS)
        n_up, up_ms, up_bytes = r["uploads"]
        log(f"11b {name} rows, blocks of {HOST11_BLOCK}: session + proof "
            f"{wall:.2f} s, peak device memory "
            f"{r['peak_bytes'] / 2**30:.3f} GiB, sha256 equals phase 4's")
        for lap in ("stage params (host->device)", "H pipeline (device NTT)",
                    MSM_LAP):
            log(f"  phase {lap}: {r['laps'][lap]:.3f} s")
        log(f"  uploads on the copy stream: {n_up}, {up_ms:.1f} ms of "
            f"device time for {up_bytes / 1e9:.3f} GB"
            + (f" ({up_bytes / up_ms / 1e6:.1f} GB/s)" if up_ms else "")
            + f", beside the MSM lap of {r['laps'][MSM_LAP] * 1e3:.1f} ms")
        log(f"  launches: {r['launches']}")
        if name == "host":
            if n_up == 0:
                raise AssertionError("11b: no upload on the copy stream")
            cap = Capture(M, "msm_scan", index=0)
            with cap:
                again = sess.prove(inputs)
                torch.cuda.synchronize()
            if again != proof:
                raise AssertionError("11b: a second host-resident proof "
                                     "differs from the first")
            r["checks"] = [captured_scan_check(args, "11b host-resident")
                           for args in cap.calls]
            for k in r["checks"]:
                log(f"11b: msm_scan {k['config']} on the first "
                    f"host-resident block at {k['shape']}: kernel "
                    f"{k['ms']:.3f} ms, plain {k['plain_ms']:.1f} ms, "
                    f"equal")
            del cap
        del sess, proof
        out[name] = r
    gap = out["resident"]["peak_bytes"] - out["host"]["peak_bytes"]
    need = out["resident"]["row_bytes"] / 2
    log(f"11b: peak gap {gap / 2**30:.3f} GiB, rows "
        f"{out['resident']['row_bytes'] / 2**30:.3f} GiB (need at least "
        f"{need / 2**30:.3f})")
    if gap < need:
        raise AssertionError(f"11b: host-resident peak only "
                             f"{gap / 2**30:.3f} GiB below the resident "
                             f"one")
    torch.cuda.empty_cache()
    return out


def rank_host_resident(rank, files6) -> dict:
    """11c: prove_sharded with each rank's G1 rows in host memory."""
    return _rank_proof(rank, "MNT6753", *files6,
                       block_points=SHARDED11_BLOCK, resident_bytes=0)


def host_sharded_phase(run6) -> list:
    """11c: prove_sharded at world 2 on gloo, both ranks on the one card,
    MNT6753 2^15 with resident_bytes = 0 and global blocks of
    SHARDED11_BLOCK: every rank's proof equals phase 4's."""
    t0 = time.time()
    ranks = multihost.launch_local(rank_host_resident, 2,
                                   ((run6["params"], run6["input"]),),
                                   backend="gloo", timeout=RANK_TIMEOUT)
    log(f"11c: world 2 (gloo, one card) launch {time.time() - t0:.1f} s")
    for r in ranks:
        log_rank(f"11c MNT6753 2^{run6['log2']} host-resident", r)
        n_up, up_ms, up_bytes = r["uploads"]
        log(f"  uploads on the copy stream: {n_up}, {up_ms:.1f} ms for "
            f"{up_bytes / 1e9:.3f} GB")
        require_launched(f"11c rank {r['rank']}", r["launches"],
                         PATH_KERNELS)
        if n_up == 0:
            raise AssertionError(f"11c rank {r['rank']}: no upload")
        if r["sha"] != run6["sha"]:
            raise AssertionError(f"11c rank {r['rank']}: the proof differs "
                                 f"from phase 4's")
    log("11c: every rank's host-resident proof equals phase 4's (MNT6753 "
        "2^15)")
    return ranks


def host_memory() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    return out


def host_rows_phase(rng) -> dict:
    """11d: an MNT4753 proof at d + 1 = 2^25 through a ProverSession on
    utils/synthetic.params_arrays, unforced: its 38.65 GB of rows pass 3/8
    of the card, so they stay in host memory and every block goes up from
    a pinned staging buffer on the copy stream (UploadTimer); the params
    are dropped once the session holds its copy, then the input is made.
    A, B and C equal the known logs (with the proof's own H); the first
    bucket scan of each MSM (captured in the proof, so its operands stay
    on the card until the end) is held against the plain scan."""
    curve, log2 = MNT4753, HOST11D_LOG2
    d1 = 1 << log2
    blocks = default_blocks(log2)
    row_bytes = 4 * sum(per * nblk * w for (nblk, per, _), w in zip(
        blocks.values(), (48, 96)))
    mem = host_memory()
    # the params and the session's one padded copy of them, with about
    # 8 GiB for the process and the input made after the params go
    need = 2 * row_bytes + (8 << 30)
    log(f"11d: host memory {mem['MemTotal'] / 2**30:.1f} GiB, "
        f"{mem['MemAvailable'] / 2**30:.1f} GiB available; the proof needs "
        f"about {need / 2**30:.1f} GiB (twice {row_bytes / 1e9:.2f} GB of "
        f"rows)")
    if mem["MemAvailable"] < need:
        raise AssertionError(
            f"11d: MNT4753 2^{log2} with host rows needs about "
            f"{need / 2**30:.1f} GiB of host memory; this machine has "
            f"{mem['MemAvailable'] / 2**30:.1f} GiB available of "
            f"{mem['MemTotal'] / 2**30:.1f} GiB")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    laps = {}
    with HostPeak() as host, UploadTimer() as uploads, KeepH() as keep_h, \
            KernelTimer(MSM_TARGETS) as timer, \
            Capture(M, "msm_scan", index=0) as cap:
        t0 = time.time()
        params = params_arrays(curve, log2)
        laps["params_arrays"] = time.time() - t0
        t0 = time.time()
        sess = GP.ProverSession(curve, params, DEV)
        laps["session"] = time.time() - t0
        staged_rss = rss_bytes()
        del params
        t0 = time.time()
        values = input_values(curve, log2, rng)
        laps["input_values"] = time.time() - t0
        t0 = time.time()
        proof = sess.prove(input_arrays(values))
        torch.cuda.synchronize()
        laps["prove"] = time.time() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    phases = profiling.last_laps()
    in_proof = timer.totals()
    n_up, up_ms, up_bytes = uploads.totals()
    log(f"11d MNT4753 2^{log2}: resident={sess.resident}, session "
        f"{laps['session']:.2f} s + proof {laps['prove']:.2f} s (params "
        f"made in {laps['params_arrays']:.1f} s, input in "
        f"{laps['input_values']:.1f} s), peak device memory "
        f"{peak / 2**30:.2f} GiB, peak host RSS {host.peak / 2**30:.2f} GiB "
        f"({staged_rss / 2**30:.2f} GiB with the params and the session's "
        f"rows)")
    for name, dt in phases.items():
        log(f"  phase {name}: {dt:.3f} s")
    log(f"  uploads on the copy stream: {n_up}, {up_ms:.1f} ms of device "
        f"time for {up_bytes / 1e9:.3f} GB"
        + (f" ({up_bytes / up_ms / 1e6:.1f} GB/s)" if up_ms else "")
        + f", beside the MSM lap of {phases[MSM_LAP]:.3f} s")
    log(f"  launches: {launches}")
    log_timer("in the proof", in_proof)
    if sess.resident:
        raise AssertionError("11d: the session kept its rows on the card")
    require_launched("11d", launches, PATH_KERNELS)
    n_blocks = sum(nblk for nblk, _, _ in blocks.values())
    if n_up != n_blocks or uploads.stray:
        raise AssertionError(f"11d: {n_up} uploads for {n_blocks} blocks, "
                             f"{uploads.stray} not from pinned memory on "
                             f"the copy stream")
    check_blocks("11d", in_proof, blocks)
    h_k, = keep_h.outs
    want = known_proof(curve, KS, query_logs(log2), values[0],
                       h_k[1].numpy(), values[4])
    del h_k, keep_h, values, sess
    require_proof(f"MNT4753 2^{log2} host rows", proof, want)
    log(f"11d: A, B, C match the known logs (m = {d1})")
    held = sum(t.numel() * t.element_size() for args in cap.calls
               for t in args[1:] if torch.is_tensor(t))
    checks = [captured_scan_check(args, "11d host rows")
              for args in cap.calls]
    for k in checks:
        log(f"11d: msm_scan {k['config']} on the first host block at "
            f"{k['shape']}: kernel {k['ms']:.3f} ms, plain "
            f"{k['plain_ms']:.1f} ms, equal (its operands, "
            f"{held / 2**30:.2f} GiB for both MSMs, count in the peak)")
    del cap
    torch.cuda.empty_cache()
    return dict(launches=launches, peak_bytes=peak, host_peak_bytes=host.peak,
                laps=laps, phases=phases, uploads=(n_up, up_ms, up_bytes),
                checks=checks)


# -- phase 12: the entry points of __graft_entry_torch__.py --------------

ENTRY_KERNELS = ("ec_add", "ec_dbl", "msm_scan")
ENTRY_C = 8                # entry()'s window width


def entry_phase() -> dict:
    """12a: entry()'s fn on the card, its launches, word for word against
    fn on CPU copies of the args (the plain route), the finalized sum
    against the host MSM of the example's 128 scalars, and its time."""
    fn, (keys, rows) = GE.entry()
    if keys.device.type != "cuda" or rows.device.type != "cuda":
        raise AssertionError("12a: entry()'s args are not on the card")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    ws = fn(keys, rows)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = counts()
    require_launched("12a entry fn", launches, ENTRY_KERNELS)
    t1 = time.time()
    plain = fn(keys.cpu(), rows.cpu())
    plain_s = time.time() - t1
    err = require_equal("12a entry fn", ws.cpu(), plain)
    curve = MNT4753
    hg = HE.g1_group(curve)
    gen = HE.g1_generator(curve)
    base = [hg.mul(3 + 5 * i, gen) for i in range(8)]
    scalars = L.words_to_ints(keys.cpu().numpy())
    want = HM.msm(hg, scalars, [base[i % 8] for i in range(len(scalars))])
    got = M.finalize_windows(get_curve_ops(curve, "g1"), hg, ws, ENTRY_C)[0]
    if not hg.equal(got, want):
        raise AssertionError("12a: entry fn's finalized sum != host MSM")
    ms = cuda_ms(lambda: fn(keys, rows), 10)
    log(f"12a: entry() fn on the card {tuple(ws.shape)}: first call "
        f"{first_s:.3f} s, {ms:.3f} ms a call (CUDA events, 10 calls); "
        f"launches {launches}; equal to the plain route on the CPU "
        f"({plain_s:.1f} s) word for word; finalized sum == host MSM")
    return dict(launches=launches, ms=ms, first_s=first_s, plain_s=plain_s,
                max_abs_err=err)


def dryrun_phase() -> dict:
    """12b: dryrun_multichip(1) (nccl, world 1) and dryrun_multichip(2)
    (two gloo ranks on the one card); each checks every rank's proof
    against the unmasked host oracle and raises otherwise."""
    torch.cuda.empty_cache()
    out = {}
    for n, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.time()
        r = GE.dryrun_multichip(n)
        wall = time.time() - t0
        if r["backend"] != backend or len(r["ranks"]) != n:
            raise AssertionError(f"12b dryrun_multichip({n}): backend "
                                 f"{r['backend']}, {len(r['ranks'])} ranks")
        for rank in r["ranks"]:
            require_launched(f"12b dryrun_multichip({n}) rank "
                             f"{rank['rank']}", rank["launches"],
                             PATH_KERNELS)
        log(f"12b: dryrun_multichip({n}) ({backend}, 2^{r['log2_d']}): "
            f"{wall:.1f} s (setup {r['setup_s']:.1f}, ranks "
            f"{r['prove_s']:.1f}, oracle {r['oracle_s']:.1f}); "
            f"prove_sharded a rank "
            f"{[round(k['seconds'], 3) for k in r['ranks']]} s; launches "
            f"{[k['launches'] for k in r['ranks']]}")
        out[n] = dict(r, wall_s=wall)
    return out


# -- phase 13: the bench ---------------------------------------------------

BENCH13_ENV = {"BENCH_LOG2N": "16", "BENCH_G2_LOG2N": "12",
               "BENCH_NTT_LOG2N": "16", "BENCH_REPS": "2",
               "BENCH_SKIP_PROOF20": "1", "BENCH_PROOF_LOG2D": "0"}
BENCH13_LAUNCHED = {"msm": ("msm_scan", "ec_add", "ec_dbl"),
                    "g2": ("msm_scan", "ec_add", "ec_dbl"),
                    "ntt": ("mont_mul",)}


def bench_phase() -> dict:
    """13: bench_torch.py at BENCH13_ENV's sizes, its leg groups in
    subprocesses of its own: exit 0, a non-null value, every leg that ran
    correct, and each leg's kernels launched in its timed calls."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH13_ENV)
    torch.cuda.empty_cache()
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        log(res.stderr[-6000:])
        raise AssertionError(f"bench_torch.py exited {res.returncode}")
    last = json.loads(lines[-1])
    log(f"bench_torch: {lines[-1]}")
    detail = last["detail"]
    if last["value"] is None:
        raise AssertionError("bench_torch.py printed no value")
    for leg in ("msm", "proof20", "g2", "ntt", "proof"):
        r = detail[leg]
        if "skipped" in r:
            if leg in BENCH13_LAUNCHED:
                raise AssertionError(f"bench leg {leg} was skipped")
            continue
        if r.get("correct") is not True:
            raise AssertionError(f"bench leg {leg} is not correct: {r}")
        require_launched(f"bench leg {leg}", r["launches"],
                         BENCH13_LAUNCHED[leg])
    log(f"13: bench_torch.py {wall:.1f} s, exit 0, value "
        f"{last['value']:.1f} points/s at 2^16; msm, g2, ntt correct; "
        f"launches " + ", ".join(f"{leg} {detail[leg]['launches']}"
                                 for leg in BENCH13_LAUNCHED))
    return dict(wall_s=wall, line=last)


def check_ptxas() -> None:
    """Print registers, stack and spills per kernel; the lane kernels of
    the G1 and Fq2 configurations must keep their state in registers."""
    for unit, kern, regs, stack, spill in build.ptxas_summary(
            build.ptxas_report()):
        log(f"ptxas {unit} {kern}: {regs} registers, {stack} B stack, "
            f"{spill} B spill stores")
        lane_unit = unit.startswith(("group", "msm_scan"))
        if lane_unit and unit[-1] in "012" and (stack or spill):
            raise AssertionError(f"{unit} {kern}: {stack} B of stack, "
                                 f"{spill} B of spill stores")


def kernel_entry(name, cfg, results, launches, in_proof) -> dict:
    r = results[name, cfg]
    entry = {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name], "launches": launches,
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None,
             "shape": r["shape"], "config": r["config"]}
    for key in ("path_shape", "path_ms", "path_plain_ms", "path_bound_ms",
                "path_max_abs_err", "straus_shape", "straus_ms",
                "straus_plain_ms", "straus_max_abs_err", "setup_shape",
                "setup_ms", "setup_plain_ms", "setup_bound_ms",
                "setup_bound_by", "setup_max_abs_err"):
        if key in r:
            entry[key] = r[key]
    if (name, cfg) in in_proof:
        entry["proof_ms_total"] = in_proof[name, cfg][1]
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    # the table path is driven by phases 6 and 7 alone
    os.environ.pop("GROTH16_PREPROCESSED_PATH", None)
    card = card_line()
    log(f"card: {card}")

    t0 = time.time()
    build.library()
    log(f"build: {time.time() - t0:.1f} s")
    log(build.ptxas_report())
    check_ptxas()

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

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as workdir:
        # no table file in the working directory: phases 3 to 5 take the
        # Pippenger path
        os.chdir(workdir)
        try:
            fixture_gate(workdir)
            log(f"fixture gate done at {time.time() - t0:.1f} s")
            streamed_msm(rng)
            log(f"streamed MSM done at {time.time() - t0:.1f} s")
            run4 = full_proof(MNT4753, 20, workdir, rng)
            run6 = full_proof(MNT6753, 15, workdir, rng)
            log(f"full-size proofs done at {time.time() - t0:.1f} s")
            pre6 = table_files_phase(rng, run6, workdir, results)
            log(f"table path through files done at {time.time() - t0:.1f} s")
            tab4 = table_memory_phase(rng, run4, results)
            log(f"table path in memory done at {time.time() - t0:.1f} s")
            serve4 = serve_phase(rng, run4, workdir)
            log(f"serve done at {time.time() - t0:.1f} s")
            native_epilogue_check((run4, run6))
            del run4["window_sums"], run6["window_sums"]
            small = setup_oracle_phase(rng, workdir, results)
            log(f"setup against the host oracle done at "
                f"{time.time() - t0:.1f} s")
            keys = setup_full_phase(workdir, results)
            log(f"setup at working size done at {time.time() - t0:.1f} s")
            bexp = batch_exp_full_phase(rng, results)
            log(f"batch_exp at 2^20 done at {time.time() - t0:.1f} s")
            par = sharded_phase(run4, run6)
            log(f"multi-device prover done at {time.time() - t0:.1f} s")
            run24 = streamed_default_phase(workdir, rng)
            log(f"11a resident-row 2^24 proof done at "
                f"{time.time() - t0:.1f} s")
            host = host_resident_phase(run4)
            log(f"11b host-resident rows done at {time.time() - t0:.1f} s")
            host_par = host_sharded_phase(run6)
            log(f"11c host-resident sharded proof done at "
                f"{time.time() - t0:.1f} s")
            host25 = host_rows_phase(rng)
            log(f"11d host-row 2^25 proof done at {time.time() - t0:.1f} s")
            entry12 = entry_phase()
            dry12 = dryrun_phase()
            log(f"12 entry points done at {time.time() - t0:.1f} s")
            bench_phase()
            log(f"13 bench done at {time.time() - t0:.1f} s")
        finally:
            os.chdir(cwd)
    log(f"smoke wall time: {time.time() - t0:.1f} s, the build included")

    # The first four entries: the kernels of the path on the MNT4753 2^20
    # proof (G1 shapes; mont_mul over its Fr), launches from that proof.
    kernels = []
    for name in PATH_KERNELS:
        entry = kernel_entry(name, 0, results, run4["launches"][name],
                             run4["in_proof"])
        entry["launches_mnt6753_2p15"] = run6["launches"][name]
        entry["launches_table_proof_2p20"] = tab4["launches"][name]
        entry["launches_serve_2_proofs_2p20"] = serve4["launches"][name]
        entry["launches_sharded_world1_2p20"] = \
            par["world1"]["launches"][name]
        for key, tag in (("mnt4753", "2p20"), ("mnt6753", "mnt6753_2p15")):
            entry[f"launches_sharded_world2_{tag}"] = [
                r[key]["launches"][name] for r in par["world2"]]
        entry["launches_resident_2p24"] = run24["launches"][name]
        entry["launches_host_2p25"] = host25["launches"][name]
        entry["launches_resident_blocks_2p20"] = \
            host["resident"]["launches"][name]
        entry["launches_host_resident_2p20"] = host["host"]["launches"][name]
        entry["launches_host_resident_sharded_mnt6753_2p15"] = [
            r["launches"][name] for r in host_par]
        entry["launches_entry_fn"] = entry12["launches"][name]
        for n in (1, 2):
            entry[f"launches_dryrun_world{n}_2p6"] = [
                r["launches"][name] for r in dry12[n]["ranks"]]
        kernels.append(entry)
    kernels[3]["host_resident_checks"] = host["host"]["checks"]
    kernels[3]["host_2p25_checks"] = host25["checks"]
    kernels[0]["launches_table_build_2p20"] = tab4["build"]["mont_mul"]
    # The other group configurations of the group add and the scan, each
    # with its own launches in the proof that runs it.
    for cfg, run in ((1, run4), (2, run6), (3, run6)):
        for name in ("ec_add", "msm_scan"):
            calls = run["in_proof"].get((name, cfg), (0, 0.0))[0]
            if calls <= 0:
                raise AssertionError(f"{name} cfg {cfg} never launched in "
                                     f"its proof")
            kernels.append(kernel_entry(name, cfg, results, calls,
                                        run["in_proof"]))
    # ec_add launches per configuration in the table proofs: the A|H
    # Pippenger pass plus the Straus trees
    for entry, cfg in zip(kernels[4:], (1, 1, 2, 2, 3, 3)):
        if entry["name"] != "ec_add":
            continue
        tab, key = ((tab4, "launches_table_proof_2p20") if cfg < 2 else
                    (pre6, "launches_table_proof_mnt6753_2p15"))
        entry[key] = sum(tab["in_proof"].get((name, cfg), (0, 0.0))[0]
                         for name in ("ec_add", "straus ec_add"))
    kernels[1]["launches_table_proof_2p20_straus"] = \
        tab4["in_proof"][("straus ec_add", 0)][0]
    # ec_mixed_add: the table build, launches per build of B1, B2 and L
    for cfg, tab, size in ((0, tab4, "MNT4753 2^20"),
                           (1, tab4, "MNT4753 2^20"),
                           (2, pre6, "MNT6753 2^15"),
                           (3, pre6, "MNT6753 2^15")):
        calls = tab["build_calls"].get(("ec_mixed_add", cfg), (0, 0.0))[0]
        if calls != (62 if cfg % 2 == 0 else 31):
            raise AssertionError(f"ec_mixed_add cfg {cfg}: {calls} launches "
                                 f"in the {size} table build")
        entry = kernel_entry("ec_mixed_add", cfg, results, calls, {})
        entry["table_build"] = size
        entry["build_ms_total"] = \
            tab["build_calls"][("ec_mixed_add", cfg)][1]
        kernels.append(entry)
    # the kernels at the widths of phase 10b's ranks (a second proof in
    # each rank), against their plain versions
    for r in par["world2"]:
        for key in ("mnt4753", "mnt6753"):
            for k in r[key]["checks"]:
                same = [e for e in kernels if e["name"] == k["name"]]
                entry = next((e for e in same
                              if e["config"] == k["config"]), same[0])
                entry.setdefault("sharded_checks", []).append(
                    dict(k, rank=r[key]["rank"], curve=r[key]["curve"]))
    # setup launches per kernel (all group configurations together)
    for entry in kernels:
        k = entry["name"]
        entry["launches_setup_mnt4753_2p16"] = \
            keys["MNT4753"]["launches"][k]
        entry["launches_setup_mnt6753_2p15"] = \
            keys["MNT6753"]["launches"][k]
        entry["launches_batch_exp_2p20"] = sum(
            bexp[g]["launches"][k] for g in ("g1", "g2"))
        entry["launches_setup_scan_33"] = sum(
            small[f"scan {g}"][k] for g in ("g1", "g2"))
    missing = [k for k in ("mont_mul", "ec_add", "ec_dbl", "ec_mixed_add")
               if not any(e["name"] == k and (e["launches_setup_mnt4753_2p16"]
                                              + e["launches_setup_scan_33"])
                          for e in kernels)]
    if missing:
        raise AssertionError(f"never launched in setup: {missing}")
    print(json.dumps({"entry_points": {
        "entry_fn": {k: entry12[k] for k in ("ms", "first_s", "plain_s",
                                             "max_abs_err", "launches")},
        "dryrun": {f"world{n}": {k: r[k] for k in (
            "backend", "log2_d", "wall_s", "setup_s", "prove_s",
            "oracle_s")} | {"rank_s": [
                k["seconds"] for k in r["ranks"]]}
            for n, r in dry12.items()}}}), flush=True)
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
