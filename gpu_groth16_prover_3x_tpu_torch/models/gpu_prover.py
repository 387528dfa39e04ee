"""The Groth16 prover on PyTorch and CUDA.

The counterpart of gpu_groth16_prover_3x_tpu/models/tpu_prover.py (and of
the reference's run_prover, cuda_prover_piecewise.cu:96-230).  One proof:

  load params / input (raw Montgomery words, a bitcast of the file)
  -> stage the G1 rows (A | B1 | L | H) and the B2 rows on the device,
     or keep them in host memory past `resident_bytes` (ProverSession)
  -> H polynomial (ops/ntt.compute_h: iFFT, coset FFT, a*b - c, / Z,
     inverse coset FFT over Fr)
  -> witness keys out of Montgomery form (`from_monty_keys`)
  -> one fused 4-way G1 Pippenger MSM and one G2 MSM for B2
     (ops/msm.msm_window_sums_streamed: blocks of points, host rows
     uploaded a block at a time on a copy stream)
  -> exact host Horner epilogue (native, ops/msm.finalize_windows),
     C = Ht + Lt + r * Bt1, write_output.

With preprocessed tables (`<CURVE>_preprocessed`, written by
models/preprocess_device.py) B1, B2 and L run the table MSM
(ops/straus.py) instead, while A and H share one 2-way Pippenger pass, as
the JAX package's table path does (tpu_prover.prove with tables).
`serve_files` stages one parameter set and proves many inputs against it.

Proof formula (challenge-simplified Groth16, no s-randomness,
libsnark/main.cpp:219): A = w*A_query, B = w*B2_query,
C = H(x)*H_query + w_aux*L_query + r * (w*B1_query).

Every entry point takes a `device` ("cuda" unless the caller asks for
"cpu").  On a CUDA device each kernel of ops/ runs; on the CPU their plain
versions run.  Proof bytes are the same either way.
"""

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..curves.constants import CURVES, CurveParams
from ..host import ec as host_ec
from ..ops import limbs as L
from ..ops.ec import get_curve_ops
from ..ops.mont_mul import mont_mul
from ..ops.msm import (DEFAULT_CHUNK, finalize_windows, grid_points,
                       msm_window_sums_streamed)
from ..ops.ntt import NttPlan, compute_h, const_words
from ..ops.straus import STRAUS_C, straus_window_sums
from ..utils import serialization as ser
from ..utils.profiling import enter_block, leave_block, log_device_memory

STREAM_ABOVE = 1 << 22      # stream the MSM in blocks beyond this many rows
STREAM_BLOCK = 1 << 21      # points per streamed block
# w[0] is the constant 1 and w[1] the one primary input of the file format
# (generate_parameters.cpp:88-107); L covers the auxiliary inputs after them
PI1 = 2


# -- raw-word parameter / input containers -----------------------------------------

@dataclass
class DeviceParams:
    """Groth16 parameters (libsnark/main.cpp:27-46) as affine point rows
    of 32-bit Montgomery words: (count, 2*deg*24) int32, x then y."""
    d: int
    m: int
    A: np.ndarray     # (m+1, 48)
    B1: np.ndarray    # (m+1, 48)
    B2: np.ndarray    # (m+1, 2*deg*24)
    L: np.ndarray     # (m-1, 48)
    H: np.ndarray     # (d, 48)


@dataclass
class DeviceInput:
    """Prover input as raw Montgomery words (count, 24) int32, plus r."""
    w_mont: np.ndarray    # (m+1, 24)
    ca: np.ndarray        # (d+1, 24)
    cb: np.ndarray
    cc: np.ndarray
    r: int                # standard domain


def _read_rows(f, count: int, ncoef: int) -> np.ndarray:
    raw = ser.read_raw_u64(f, count * ncoef)
    return L.u64_to_words(raw).reshape(count, ncoef * L.NWORDS)


def load_params(path: str, curve: CurveParams) -> DeviceParams:
    """Bulk parameter load (layout: generate_parameters.cpp:60-85)."""
    deg = curve.ext_degree
    with open(path, "rb") as f:
        d = ser.read_size_t(f)
        m = ser.read_size_t(f)
        A = _read_rows(f, m + 1, 2)
        B1 = _read_rows(f, m + 1, 2)
        B2 = _read_rows(f, m + 1, 2 * deg)
        Lq = _read_rows(f, m - 1, 2)
        H = _read_rows(f, d, 2)
        ser.check_trailing(f, path)
    return DeviceParams(d, m, A, B1, B2, Lq, H)


def load_input(path: str, curve: CurveParams, d: int, m: int) -> DeviceInput:
    """Bulk input load (layout: generate_parameters.cpp:88-107)."""
    with open(path, "rb") as f:
        w = _read_rows(f, m + 1, 1)
        ca = _read_rows(f, d + 1, 1)
        cb = _read_rows(f, d + 1, 1)
        cc = _read_rows(f, d + 1, 1)
        r = ser.read_fq(f, curve.fr.p)
        ser.check_trailing(f, path)
    return DeviceInput(w, ca, cb, cc, r)


def load_preprocessed(path: str, curve: CurveParams, m: int, nL: int):
    """Bulk load of `<CURVE>_preprocessed` (layout: the JAX package's
    tpu_prover.load_preprocessed, the reference's output_g1_multiples,
    libsnark/main.cpp:248-339): for B1 (m+1 G1 points), B2 (m+1 G2) and
    L (nL G1), 2^5 - 1 rows of affine points, row-major by multiple, so
    row k*n + i holds (k+1) * P_i.  Returns (B1_t, B2_t, L_t) word rows."""
    nmul = (1 << STRAUS_C) - 1
    deg = curve.ext_degree
    with open(path, "rb") as f:
        B1_t = _read_rows(f, nmul * (m + 1), 2)
        B2_t = _read_rows(f, nmul * (m + 1), 2 * deg)
        L_t = _read_rows(f, nmul * nL, 2)
        ser.check_trailing(f, path)
    return B1_t, B2_t, L_t


def params_from_jax(jp) -> DeviceParams:
    """The JAX package's DeviceParams (u16 limb rows (n, 2*deg*48)) ->
    the port's word rows: the same parameters, carried across."""
    return DeviceParams(jp.d, jp.m, *(L.jax_rows_to_words(a) for a in
                                      (jp.A, jp.B1, jp.B2, jp.L, jp.H)))


def input_from_jax(ji) -> DeviceInput:
    """The JAX package's DeviceInput ((n, 48) 16-bit limbs) -> words."""
    return DeviceInput(*(L.jax_rows_to_words(a) for a in
                         (ji.w_mont, ji.ca, ji.cb, ji.cc)), ji.r)


def tables_from_jax(jax_tables):
    """The JAX package's (B1_t, B2_t, L_t) u16 limb rows -> word rows."""
    return tuple(L.jax_rows_to_words(t) for t in jax_tables)


# -- the prover ----------------------------------------------------------------------

def sync_device(device: torch.device) -> None:
    """Drain the stream at a phase boundary so each block timer measures
    the work its phase issued (the reference syncs around its print_time
    calls, cuda_prover_piecewise.cu:183-196)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def from_monty_keys(fr_ctx: L.MontCtx, mont_cols: torch.Tensor
                     ) -> torch.Tensor:
    """(24, n) Montgomery words -> standard-domain scalar words: one
    Montgomery product with the plain integer 1 (fp.tcc from_monty).  The
    product is canonical, so no extra subtract is needed."""
    one = const_words(1, mont_cols.shape[1], mont_cols.device)
    return mont_mul(fr_ctx, mont_cols, one)


def resolve_msm_cfg(m: int, device: torch.device):
    """Chunk length, window width and digit kind for an m-variable proof.

    c = 16 bits from 2^16 variables, else 8: the 2^c-bucket reduction
    costs O(2^c) group ops per window, so small proofs take the small
    window.  The CPU takes c = 4 with unsigned digits (tiny bucket tables
    for the plain versions), as the JAX package does on XLA:CPU.  Proof
    bytes do not depend on c or on the digit kind."""
    cpu = device.type == "cpu"
    c = 4 if cpu else (16 if m >= (1 << 16) else 8)
    # keep enough chunks (scan threads) busy at small sizes
    chunk_s = min(DEFAULT_CHUNK, max(8, (2 * m) // 128))
    return chunk_s, c, not cpu


def pad_rows(rows: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad with y == 0 rows: the serialized point at infinity."""
    out = np.zeros((n_pad, rows.shape[1]), dtype=np.int32)
    out[:rows.shape[0]] = rows
    return out


def round_up(n: int, q: int) -> int:
    return max(q, -(-n // q) * q)


def resolve_resident_bytes(resident_bytes, device: torch.device) -> float:
    """The most bytes of query rows a session keeps on its device: the
    argument, else $GROTH16_MSM_RESIDENT_BYTES (as in the JAX package),
    else 3/8 of the card's memory (the JAX package's 6 of 16 GiB carried
    over; on an 80 GB H100 about 31.9 GB, so MNT4753 rows stay resident up
    to d + 1 = 2^24, 19.3 GB, and stay on the host from 2^25, 38.7 GB).
    Measured on an H100 80GB HBM3 at 700 W (prove_at_scale.py): the 2^24
    proof with its rows resident peaks at 42.6 GiB, and a 2^25 proof with
    none peaks at 44.6 GiB in its H pipeline, so even rows just under 3/8
    (29.7 GiB) beside a 2^25 H pipeline would stay under 75 GiB.
    On the CPU every row is resident: the device is host memory."""
    if resident_bytes is None:
        env = os.environ.get("GROTH16_MSM_RESIDENT_BYTES")
        if env is not None:
            resident_bytes = int(env)
        elif device.type == "cuda":
            resident_bytes = torch.cuda.get_device_properties(
                device).total_memory * 3 // 8
        else:
            resident_bytes = float("inf")
    return resident_bytes


def resolve_block_points(block_points, n_pad: int, resident: bool):
    """Points per streamed MSM block, or None for one pass: the argument
    (0 = one pass), else $GROTH16_MSM_BLOCK_POINTS (0 = one pass; as
    tpu_prover.py:331-335), else STREAM_BLOCK past STREAM_ABOVE rows.
    Host-resident rows always go in blocks of at most STREAM_BLOCK."""
    if block_points is None:
        env = os.environ.get("GROTH16_MSM_BLOCK_POINTS")
        if env is not None:
            block_points = int(env)
        else:
            block_points = STREAM_BLOCK if n_pad > STREAM_ABOVE else 0
    if not resident:
        block_points = min(block_points or STREAM_BLOCK, STREAM_BLOCK)
    return block_points or None


def stage_rows(parts, n_pad: int, device, resident: bool):
    """The query rows `parts` side by side, padded with y == 0 rows to
    n_pad, in one array filled part by part: on the device (each part
    copied up from its host array), or kept on the host as contiguous
    numpy (ops/msm.msm_window_sums_streamed uploads it a block at a
    time).  No other copy of the rows is made."""
    width = parts[0].shape[1]
    host = None if resident else np.zeros((n_pad, width), dtype=np.int32)
    out = (torch.zeros((n_pad, width), dtype=torch.int32, device=device)
           if resident else torch.from_numpy(host))
    lo = 0
    for part in parts:
        # torch's copy runs on every core: 2^25 rows in seconds
        out[lo:lo + len(part)].copy_(torch.from_numpy(
            np.ascontiguousarray(part)))
        lo += len(part)
    return out if resident else host


def stage_cols(rows: np.ndarray, device) -> torch.Tensor:
    """(count, 24) host rows -> (24, count) words on the device: rows that
    are a transposed view go up as they lie, others go up row-major and
    are transposed there (numpy takes seconds to transpose 2^24 rows)."""
    if rows.T.flags.c_contiguous:
        return torch.from_numpy(rows.T).to(device)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device).t() \
        .contiguous()


def pad_keys(parts, n_pad: int) -> torch.Tensor:
    """(24, n_pad) scalar words: the (24, k) parts side by side, then zero
    keys (no-ops against the padding rows)."""
    out = parts[0].new_zeros((L.NWORDS, n_pad))
    lo = 0
    for part in parts:
        out[:, lo:lo + part.shape[1]] = part
        lo += part.shape[1]
    return out


class ProverSession:
    """One parameter set staged for a device; `prove` runs one proof.

        sess = ProverSession(curve, params, device="cuda")
        proof = sess.prove(inputs)

    With `tables` (B1_t, B2_t, L_t), word rows as host arrays or tensors
    already on the device (load_preprocessed, or the tables of
    preprocess_device.multiples_rows), B1, B2 and L run the table MSM and
    only A and H are staged for Pippenger.

    The Pippenger query rows (G1 and B2; A and H alone with tables) stay
    on the device when they take at most `resident_bytes`
    (resolve_resident_bytes); otherwise they stay in host memory and each
    MSM uploads them a block at a time, each upload under the card's
    work on the block before (the JAX package's beyond-HBM path,
    tpu_prover.py:307-327).  `block_points` (resolve_block_points) streams the MSMs in
    blocks of that many points.  A serve session keeps its host rows
    between proofs.  Proof bytes depend on neither."""

    def __init__(self, curve: CurveParams, params: DeviceParams,
                 device="cuda", tables=None, resident_bytes=None,
                 block_points=None):
        self.device = torch.device(device)
        self.curve = curve
        self.g1 = get_curve_ops(curve, "g1")
        self.g2 = get_curve_ops(curve, "g2")
        self.fr_ctx = L.MontCtx(curve.fr.p)
        self.hg1 = host_ec.g1_group(curve)
        self.hg2 = host_ec.g2_group(curve)
        d, m = params.d, params.m
        self.d, self.m = d, m
        self.chunk_s, self.c, self.signed = resolve_msm_cfg(m, self.device)
        self.nL = params.L.shape[0]
        q = self.chunk_s

        dev = self.device
        enter_block("stage params (host->device)")
        if tables is None:
            parts = [params.A[:m + 1], params.B1[:m + 1],
                     params.L[:self.nL], params.H[:d]]
            self.tables = None
        else:
            # the table MSMs take B1, B2 and L; A and H stay on Pippenger
            parts = [params.A[:m + 1], params.H[:d]]
            self.tables = tuple(
                torch.as_tensor(t).to(dev).reshape(-1, t.shape[-1])
                for t in tables)
        self.n_tot = sum(len(a) for a in parts)
        n_pad = round_up(self.n_tot, q)
        row_bytes = n_pad * params.A.shape[1] * 4
        if tables is None:
            self.n2 = m + 1
            n2_pad = round_up(self.n2, q)
            row_bytes += n2_pad * params.B2.shape[1] * 4
        self.resident = row_bytes <= resolve_resident_bytes(resident_bytes,
                                                            dev)
        self.block_points = resolve_block_points(block_points, n_pad,
                                                 self.resident)
        # rows and keys are padded once, to the streamed MSM's block grid
        self.n_pad = grid_points(n_pad, q, self.block_points)
        self.g1_rows = stage_rows(parts, self.n_pad, dev, self.resident)
        # MSM index per G1 row (the padding joins the last MSM)
        sizes = [len(a) for a in parts]
        sizes[-1] += self.n_pad - self.n_tot
        self.seg = torch.from_numpy(np.repeat(
            np.arange(len(parts)), sizes).astype(np.int64)).to(dev)
        if tables is None:
            self.n2_pad = grid_points(n2_pad, q, self.block_points)
            self.b2_rows = stage_rows([params.B2[:self.n2]], self.n2_pad,
                                      dev, self.resident)
        self.plan = None
        sync_device(dev)
        leave_block("stage params (host->device)")

    def prove(self, inputs: DeviceInput):
        """One proof; returns affine (A, B2, C) host tuples."""
        d, m, nL = self.d, self.m, self.nL
        dev, c = self.device, self.c
        hg1, hg2 = self.hg1, self.hg2

        enter_block("stage inputs (host->device)")
        ca, cb, cc, w_mont = (stage_cols(a, dev) for a in (
            inputs.ca, inputs.cb, inputs.cc, inputs.w_mont))
        sync_device(dev)
        leave_block("stage inputs (host->device)")

        enter_block("H pipeline (device NTT)")
        if self.plan is None:
            self.plan = NttPlan(self.curve.fr, d + 1, dev)
        _, h_std = compute_h(self.plan, ca, cb, cc)     # (24, d+1)
        del ca, cb, cc
        sync_device(dev)
        leave_block("H pipeline (device NTT)")

        enter_block("scalar from_monty (device)")
        w_keys = from_monty_keys(self.fr_ctx, w_mont)  # (24, m+1)
        del w_mont
        sync_device(dev)
        leave_block("scalar from_monty (device)")

        if self.tables is not None:
            return self._msms_with_tables(inputs.r, w_keys, h_std)

        enter_block("MSMs (device Pippenger)")
        # ONE fused G1 pass for A / B1 / L / H: the MSM index rides the
        # sort key, so the four MSMs share one sort / scan / reduction
        g1_keys = pad_keys([w_keys[:, :m + 1], w_keys[:, :m + 1],
                            w_keys[:, PI1:PI1 + nL], h_std[:, :d]],
                           self.n_pad)
        b2_keys = pad_keys([w_keys[:, :self.n2]], self.n2_pad)
        del w_keys, h_std
        ws_g1 = msm_window_sums_streamed(
            self.g1, g1_keys, self.g1_rows, self.chunk_s, c, self.seg, 4,
            self.block_points, self.signed)
        del g1_keys
        ws_b2 = msm_window_sums_streamed(
            self.g2, b2_keys, self.b2_rows, self.chunk_s, c, None, 1,
            self.block_points, self.signed)
        sync_device(dev)
        leave_block("MSMs (device Pippenger)")

        enter_block("readback + host assembly")
        At, Bt1, Lt, Ht = finalize_windows(self.g1, hg1, ws_g1, c, 4)
        Bt2, = finalize_windows(self.g2, hg2, ws_b2, c)
        C = hg1.add(hg1.add(Ht, Lt), hg1.mul(inputs.r, Bt1))
        out = (hg1.to_affine(At), hg2.to_affine(Bt2), hg1.to_affine(C))
        leave_block("readback + host assembly")
        return out

    def _msms_with_tables(self, r: int, w_keys, h_std):
        """The MSMs of the table path (tpu_prover.prove with tables,
        cuda_prover_piecewise.cu:162-187) and the host assembly."""
        d, m, nL, c = self.d, self.m, self.nL, self.c
        hg1, hg2 = self.hg1, self.hg2
        enter_block("MSMs (device: Straus tables + Pippenger A/H)")
        g1_keys = pad_keys([w_keys[:, :m + 1], h_std[:, :d]], self.n_pad)
        ws_g1 = msm_window_sums_streamed(
            self.g1, g1_keys, self.g1_rows, self.chunk_s, c, self.seg, 2,
            self.block_points, self.signed)
        del g1_keys, h_std
        B1_t, B2_t, L_t = self.tables
        w_all = w_keys[:, :m + 1].contiguous()
        ws_B1 = straus_window_sums(self.g1, w_all, B1_t)
        ws_L = straus_window_sums(
            self.g1, w_keys[:, PI1:PI1 + nL].contiguous(), L_t)
        ws_B2 = straus_window_sums(self.g2, w_all, B2_t)
        sync_device(self.device)
        leave_block("MSMs (device: Straus tables + Pippenger A/H)")

        enter_block("readback + host assembly")
        At, Ht = finalize_windows(self.g1, hg1, ws_g1, c, 2)
        Bt1, = finalize_windows(self.g1, hg1, ws_B1, STRAUS_C)
        Lt, = finalize_windows(self.g1, hg1, ws_L, STRAUS_C)
        Bt2, = finalize_windows(self.g2, hg2, ws_B2, STRAUS_C)
        C = hg1.add(hg1.add(Ht, Lt), hg1.mul(r, Bt1))
        out = (hg1.to_affine(At), hg2.to_affine(Bt2), hg1.to_affine(C))
        leave_block("readback + host assembly")
        return out


def prove(curve: CurveParams, params: DeviceParams, inputs: DeviceInput,
          device="cuda", tables=None):
    """Full proof as a one-shot session; returns affine (A, B2, C).
    `tables`: optional (B1_t, B2_t, L_t) for the table path (see
    ProverSession); proof bytes are the same either way."""
    sess = ProverSession(curve, params, device, tables)
    return sess.prove(inputs)


def prove_files(curve: CurveParams, params_path: str, input_path: str,
                output_path: str, device="cuda") -> None:
    """`gpu <CURVE> compute params input output`, with the phase-timer
    labels of the reference's print_time calls
    (cuda_prover_piecewise.cu:143-208)."""
    t0 = time.time()
    params = load_params(params_path, curve)
    print(f"load params: {time.time() - t0:.3f}s", flush=True)
    # the reference always loads `<CURVE>_preprocessed` from the working
    # directory (cuda_prover_piecewise.cu:244-247); here the tables are
    # optional and taken when the file is there
    tables = None
    pre_path = os.environ.get("GROTH16_PREPROCESSED_PATH",
                              f"{curve.name}_preprocessed")
    if os.path.isfile(pre_path):
        t1 = time.time()
        tables = load_preprocessed(pre_path, curve, params.m,
                                   params.L.shape[0])
        print(f"load preprocessing: {time.time() - t1:.3f}s", flush=True)
    t1 = time.time()
    inputs = load_input(input_path, curve, params.d, params.m)
    print(f"load inputs: {time.time() - t1:.3f}s", flush=True)
    t2 = time.time()
    proof = prove(curve, params, inputs, device=device, tables=tables)
    print(f"prove (gpu e2e): {time.time() - t2:.3f}s", flush=True)
    log_device_memory("post-prove")
    t3 = time.time()
    ser.write_output(output_path, curve, *proof)
    print(f"store: {time.time() - t3:.3f}s", flush=True)
    print(f"total: {time.time() - t0:.3f}s", flush=True)


def run_prover(curve_name: str, params_path: str, input_path: str,
               output_path: str, device="cuda") -> None:
    """CLI adapter (utils/cli.py `gpu <CURVE> compute ...`)."""
    prove_files(CURVES[curve_name], params_path, input_path, output_path,
                device=device)


def serve_files(curve_name: str, params_path: str, pairs,
                device="cuda") -> None:
    """`gpu <CURVE> serve <params> <in> <out> ...`: load and stage the
    parameter set once, then prove every (input, output) pair against it
    (the JAX package's tpu_prover.serve_files).  Pippenger path: the
    table file is not read."""
    curve = CURVES[curve_name]
    t0 = time.time()
    params = load_params(params_path, curve)
    print(f"load params: {time.time() - t0:.3f}s", flush=True)
    t1 = time.time()
    sess = ProverSession(curve, params, device)
    print(f"stage params: {time.time() - t1:.3f}s", flush=True)
    for i, (input_path, output_path) in enumerate(pairs):
        t1 = time.time()
        inputs = load_input(input_path, curve, params.d, params.m)
        print(f"[{i}] load inputs: {time.time() - t1:.3f}s", flush=True)
        t1 = time.time()
        proof = sess.prove(inputs)
        print(f"[{i}] prove (serve): {time.time() - t1:.3f}s", flush=True)
        ser.write_output(output_path, curve, *proof)
    log_device_memory("post-serve")
    print(f"total: {time.time() - t0:.3f}s", flush=True)
