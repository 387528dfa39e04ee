"""The Groth16 prover on PyTorch and CUDA.

The counterpart of gpu_groth16_prover_3x_tpu/models/tpu_prover.py (and of
the reference's run_prover, cuda_prover_piecewise.cu:96-230).  One proof:

  load params / input (raw Montgomery words, a bitcast of the file)
  -> stage the G1 rows (A | B1 | L | H) and the B2 rows on the device
  -> H polynomial (ops/ntt.compute_h: iFFT, coset FFT, a*b - c, / Z,
     inverse coset FFT over Fr)
  -> witness keys out of Montgomery form (`_from_monty_keys`)
  -> one fused 4-way G1 Pippenger MSM and one G2 MSM for B2
     (ops/msm.msm_window_sums_streamed)
  -> exact host Horner epilogue, C = Ht + Lt + r * Bt1, write_output.

Proof formula (challenge-simplified Groth16, no s-randomness,
libsnark/main.cpp:219): A = w*A_query, B = w*B2_query,
C = H(x)*H_query + w_aux*L_query + r * (w*B1_query).

Every entry point takes a `device` ("cuda" unless the caller asks for
"cpu").  On a CUDA device each kernel of ops/ runs; on the CPU their plain
versions run.  Proof bytes are the same either way.
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..curves.constants import CURVES, CurveParams
from ..host import ec as host_ec
from ..ops import limbs as L
from ..ops.ec import get_curve_ops
from ..ops.mont_mul import mont_mul
from ..ops.msm import (DEFAULT_CHUNK, finalize_msm, msm_window_sums_streamed,
                       window_sums_to_host)
from ..ops.ntt import NttPlan, compute_h, const_words
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


def params_from_jax(jp) -> DeviceParams:
    """The JAX package's DeviceParams (u16 limb rows (n, 2*deg*48)) ->
    the port's word rows: the same parameters, carried across."""
    return DeviceParams(jp.d, jp.m, *(L.jax_rows_to_words(a) for a in
                                      (jp.A, jp.B1, jp.B2, jp.L, jp.H)))


def input_from_jax(ji) -> DeviceInput:
    """The JAX package's DeviceInput ((n, 48) 16-bit limbs) -> words."""
    return DeviceInput(*(L.jax_rows_to_words(a) for a in
                         (ji.w_mont, ji.ca, ji.cb, ji.cc)), ji.r)


# -- the prover ----------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    """Drain the stream at a phase boundary so each block timer measures
    the work its phase issued (the reference syncs around its print_time
    calls, cuda_prover_piecewise.cu:183-196)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _from_monty_keys(fr_ctx: L.MontCtx, mont_cols: torch.Tensor
                     ) -> torch.Tensor:
    """(24, n) Montgomery words -> standard-domain scalar words: one
    Montgomery product with the plain integer 1 (fp.tcc from_monty).  The
    product is canonical, so no extra subtract is needed."""
    one = const_words(1, mont_cols.shape[1], mont_cols.device)
    return mont_mul(fr_ctx, mont_cols, one)


def _resolve_msm_cfg(m: int, device: torch.device):
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


def _pad_rows(rows: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad with y == 0 rows: the serialized point at infinity."""
    out = np.zeros((n_pad, rows.shape[1]), dtype=np.int32)
    out[:rows.shape[0]] = rows
    return out


def _round_up(n: int, q: int) -> int:
    return max(q, -(-n // q) * q)


class ProverSession:
    """One parameter set staged on a device; `prove` runs one proof.

        sess = ProverSession(curve, params, device="cuda")
        proof = sess.prove(inputs)
    """

    def __init__(self, curve: CurveParams, params: DeviceParams,
                 device="cuda"):
        self.device = torch.device(device)
        self.curve = curve
        self.g1 = get_curve_ops(curve, "g1")
        self.g2 = get_curve_ops(curve, "g2")
        self.fr_ctx = L.MontCtx(curve.fr.p)
        self.hg1 = host_ec.g1_group(curve)
        self.hg2 = host_ec.g2_group(curve)
        d, m = params.d, params.m
        self.d, self.m = d, m
        self.chunk_s, self.c, self.signed = _resolve_msm_cfg(m, self.device)
        self.nL = params.L.shape[0]
        q = self.chunk_s

        enter_block("stage params (host->device)")
        g1_rows = np.concatenate([params.A[:m + 1], params.B1[:m + 1],
                                  params.L[:self.nL], params.H[:d]])
        self.n_tot = g1_rows.shape[0]
        self.n_pad = _round_up(self.n_tot, q)
        self.n2 = m + 1
        self.n2_pad = _round_up(self.n2, q)
        dev = self.device
        self.g1_rows = torch.from_numpy(_pad_rows(g1_rows, self.n_pad)).to(dev)
        self.b2_rows = torch.from_numpy(
            _pad_rows(params.B2[:self.n2], self.n2_pad)).to(dev)
        self.seg = torch.from_numpy(np.concatenate([
            np.full(m + 1, 0), np.full(m + 1, 1), np.full(self.nL, 2),
            np.full(self.n_pad - 2 * (m + 1) - self.nL, 3)])
            .astype(np.int64)).to(dev)
        self.block_points = (STREAM_BLOCK if self.n_pad > STREAM_ABOVE
                             else None)
        self.plan = None
        _sync(dev)
        leave_block("stage params (host->device)")

    def prove(self, inputs: DeviceInput):
        """One proof; returns affine (A, B2, C) host tuples."""
        d, m, nL = self.d, self.m, self.nL
        dev, c = self.device, self.c
        hg1, hg2 = self.hg1, self.hg2

        enter_block("stage inputs (host->device)")
        ca, cb, cc, w_mont = (
            torch.from_numpy(np.ascontiguousarray(a.T)).to(dev)
            for a in (inputs.ca, inputs.cb, inputs.cc, inputs.w_mont))
        _sync(dev)
        leave_block("stage inputs (host->device)")

        enter_block("H pipeline (device NTT)")
        if self.plan is None:
            self.plan = NttPlan(self.curve.fr, d + 1, dev)
        _, h_std = compute_h(self.plan, ca, cb, cc)     # (24, d+1)
        del ca, cb, cc
        _sync(dev)
        leave_block("H pipeline (device NTT)")

        enter_block("scalar from_monty (device)")
        w_keys = _from_monty_keys(self.fr_ctx, w_mont)  # (24, m+1)
        del w_mont
        _sync(dev)
        leave_block("scalar from_monty (device)")

        enter_block("MSMs (device Pippenger)")
        # ONE fused G1 pass for A / B1 / L / H: the MSM index rides the
        # sort key, so the four MSMs share one sort / scan / reduction
        g1_keys = torch.cat([
            w_keys[:, :m + 1], w_keys[:, :m + 1], w_keys[:, PI1:PI1 + nL],
            h_std[:, :d], w_keys.new_zeros((L.NWORDS,
                                            self.n_pad - self.n_tot))], 1)
        b2_keys = torch.cat([w_keys[:, :self.n2], w_keys.new_zeros(
            (L.NWORDS, self.n2_pad - self.n2))], 1)
        del w_keys, h_std
        ws_g1 = msm_window_sums_streamed(
            self.g1, g1_keys, self.g1_rows, self.chunk_s, c, self.seg, 4,
            self.block_points, self.signed)
        del g1_keys
        ws_b2 = msm_window_sums_streamed(
            self.g2, b2_keys, self.b2_rows, self.chunk_s, c, None, 1,
            self.block_points, self.signed)
        _sync(dev)
        leave_block("MSMs (device Pippenger)")

        enter_block("readback + host assembly")
        At, Bt1, Lt, Ht = (finalize_msm(hg1, pts, c) for pts in
                           window_sums_to_host(self.g1, ws_g1, num_msms=4))
        Bt2 = finalize_msm(hg2, window_sums_to_host(self.g2, ws_b2)[0], c)
        C = hg1.add(hg1.add(Ht, Lt), hg1.mul(inputs.r, Bt1))
        out = (hg1.to_affine(At), hg2.to_affine(Bt2), hg1.to_affine(C))
        leave_block("readback + host assembly")
        return out


def prove(curve: CurveParams, params: DeviceParams, inputs: DeviceInput,
          device="cuda"):
    """Full proof as a one-shot session; returns affine (A, B2, C)."""
    sess = ProverSession(curve, params, device)
    return sess.prove(inputs)


def prove_files(curve: CurveParams, params_path: str, input_path: str,
                output_path: str, device="cuda") -> None:
    """`gpu <CURVE> compute params input output`, with the phase-timer
    labels of the reference's print_time calls
    (cuda_prover_piecewise.cu:143-208)."""
    t0 = time.time()
    params = load_params(params_path, curve)
    print(f"load params: {time.time() - t0:.3f}s", flush=True)
    t1 = time.time()
    inputs = load_input(input_path, curve, params.d, params.m)
    print(f"load inputs: {time.time() - t1:.3f}s", flush=True)
    t2 = time.time()
    proof = prove(curve, params, inputs, device=device)
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
