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
Over several devices (parallel/prover.prove_sharded) each rank runs the
same session on its slice, with the sharded NTT and MSMs of
parallel/sharded.py.

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
from ..parallel.sharded import (ShardedNttPlan, rank_block,
                                sharded_msm_window_sums, sharded_ntt)
from ..utils import serialization as ser
from ..utils.profiling import (enter_block, leave_block, log_device_memory,
                               span)

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


def resolve_block_points(block_points, n_pad: int, resident: bool,
                         ndev: int = 1):
    """Points per streamed MSM block, or None for one pass: the argument
    (0 = one pass), else $GROTH16_MSM_BLOCK_POINTS (0 = one pass; as
    tpu_prover.py:331-335), else STREAM_BLOCK past STREAM_ABOVE rows.
    Host-resident rows always go in blocks of at most STREAM_BLOCK.
    Over ndev ranks of n_pad rows each (parallel/prover.py) the block is
    global, STREAM_BLOCK * ndev, as the JAX package's sharded prover
    takes it (parallel/prover.py:166-176 there)."""
    if block_points is None:
        env = os.environ.get("GROTH16_MSM_BLOCK_POINTS")
        if env is not None:
            block_points = int(env)
        else:
            block_points = STREAM_BLOCK * ndev if n_pad > STREAM_ABOVE \
                else 0
    if not resident:
        cap = STREAM_BLOCK * ndev
        block_points = min(block_points or cap, cap)
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


def upload_tables(tables, device) -> tuple:
    """(B1_t, B2_t, L_t) table rows, host arrays or tensors -> 2-D word
    rows on `device` (tensors already there are kept as they are)."""
    return tuple(torch.as_tensor(t).to(device).reshape(-1, t.shape[-1])
                 for t in tables)


class ProverSession:
    """One parameter set staged for a device; `prove` runs one proof.

        sess = ProverSession(curve, params, device="cuda")
        proof = sess.prove(inputs)

    With `tables` (B1_t, B2_t, L_t), word rows as host arrays or tensors
    already on the device (load_preprocessed, or the tables of
    preprocess_device.multiples_rows), B1, B2 and L run the table MSM and
    only A and H are staged for Pippenger.

    With `comm` (a parallel.sharded.Comm) the session is one rank of a
    group that proves together (parallel/prover.prove_sharded; every rank
    builds its session and proves the same inputs).  It stages only the
    rank's slices: the witness [lo, hi) of m + 1 padded to D * wl, the
    NTT domain [hlo, hlo + nl), and the query rows whose scalars it owns
    (A, B1 and B2 rows lo..hi, L rows lo-2..hi-2, H rows of its domain
    slice).  The H pipeline runs on the sharded four-step NTT and the
    MSMs points-sharded (parallel/sharded.py), so every rank returns the
    same proof.  Without `comm` the session is a group of one, whose
    slices are the whole; the table path runs only so.

    The Pippenger query rows (G1 and B2; A and H alone with tables) stay
    on the device when they take at most `resident_bytes`
    (resolve_resident_bytes); otherwise they stay in host memory and each
    MSM uploads them a block at a time, each upload under the card's
    work on the block before (the JAX package's beyond-HBM path,
    tpu_prover.py:307-327).  `block_points` (resolve_block_points) streams
    the MSMs in blocks of that many points, global blocks over a group.
    A serve session keeps its host rows between proofs.  Proof bytes
    depend on none of these."""

    def __init__(self, curve: CurveParams, params: DeviceParams,
                 device="cuda", tables=None, resident_bytes=None,
                 block_points=None, comm=None):
        if tables is not None and comm is not None:
            raise ValueError("the table path proves on one device: pass "
                             "tables or comm, not both")
        self.device = dev = torch.device(device)
        self.curve, self.comm = curve, comm
        self.g1 = get_curve_ops(curve, "g1")
        self.g2 = get_curve_ops(curve, "g2")
        self.fr_ctx = L.MontCtx(curve.fr.p)
        self.hg1 = host_ec.g1_group(curve)
        self.hg2 = host_ec.g2_group(curve)
        d, m = self.d, self.m = params.d, params.m
        D, rank = (1, 0) if comm is None else (comm.size, comm.rank)
        # this rank's slices; the H query has d rows, and L row i goes
        # with w[i + PI1]
        self.wl = -(-(m + 1) // D)
        lo, hi = min(rank * self.wl, m + 1), min((rank + 1) * self.wl, m + 1)
        nl = (d + 1) // D
        hlo = rank * nl
        l_lo, l_hi = max(lo, PI1), max(hi, PI1)
        h_hi = min(hlo + nl, d)
        self.w_rows, self.h_rows = slice(lo, hi), slice(hlo, hlo + nl)
        # the rank's keys of A, B1 and B2, of L and of H among its scalars
        self.keys_w, self.keys_l, self.keys_h = slice(0, hi - lo), \
            slice(l_lo - lo, l_hi - lo), slice(0, h_hi - hlo)
        # on the witness width of a rank, the same on every rank, so the
        # ranks' window sums combine
        self.chunk_s, self.c, self.signed = resolve_msm_cfg(self.wl, dev)
        q = self.chunk_s
        self.h_block, self.msm_block = (
            ("H pipeline (device NTT)", "MSMs (device Pippenger)")
            if comm is None else
            ("H pipeline (sharded NTT)", "MSMs (points-sharded Pippenger)"))

        enter_block("stage params (host->device)")
        A, H = params.A[lo:hi], params.H[hlo:h_hi]
        # the table MSMs take B1, B2 and L; A and H stay on Pippenger
        self.tables = None if tables is None else upload_tables(tables, dev)
        parts = [A, H] if tables is not None else \
            [A, params.B1[lo:hi], params.L[l_lo - PI1:l_hi - PI1], H]
        n_tot = sum(len(a) for a in parts)
        n_pad = round_up(n_tot, q)
        row_bytes = n_pad * params.A.shape[1] * 4
        if tables is None:
            n2_pad = round_up(hi - lo, q)
            row_bytes += n2_pad * params.B2.shape[1] * 4
        self.resident = row_bytes <= resolve_resident_bytes(resident_bytes,
                                                            dev)
        self.block_points = resolve_block_points(block_points, n_pad,
                                                 self.resident, D)
        # rows and keys are padded once, to the streamed MSM's block grid
        # (a group's global block walks rank_block points a rank)
        blk = self.block_points if comm is None else \
            rank_block(self.block_points, D, q)
        self.n_pad = grid_points(n_pad, q, blk)
        self.g1_rows = stage_rows(parts, self.n_pad, dev, self.resident)
        # MSM index per G1 row (the padding joins the last MSM)
        sizes = [len(a) for a in parts]
        sizes[-1] += self.n_pad - n_tot
        self.seg = torch.from_numpy(np.repeat(
            np.arange(len(parts)), sizes).astype(np.int64)).to(dev)
        if tables is None:
            self.n2_pad = grid_points(n2_pad, q, blk)
            self.b2_rows = stage_rows([params.B2[lo:hi]], self.n2_pad, dev,
                                      self.resident)
        self.plan = None
        sync_device(dev)
        leave_block("stage params (host->device)")

    def prove(self, inputs: DeviceInput):
        """One proof; returns affine (A, B2, C) host tuples.  The proof is
        the root span "proof" (utils/profiling.py): last_laps() reads its
        record afterwards."""
        with span("proof", root=True):
            return self._prove(inputs)

    def _prove(self, inputs: DeviceInput):
        dev, c, wl = self.device, self.c, self.wl

        enter_block("stage inputs (host->device)")
        ca, cb, cc = (stage_cols(a[self.h_rows], dev)
                      for a in (inputs.ca, inputs.cb, inputs.cc))
        w_mont = stage_cols(inputs.w_mont[self.w_rows], dev)
        if w_mont.shape[1] < wl:                  # the last rank's zeros
            w_mont = torch.nn.functional.pad(w_mont,
                                             (0, wl - w_mont.shape[1]))
        sync_device(dev)
        leave_block("stage inputs (host->device)")

        enter_block(self.h_block)
        if self.plan is None:
            with span("ntt.plan"):
                fr, n = self.curve.fr, self.d + 1
                self.plan = NttPlan(fr, n, dev) if self.comm is None else \
                    ShardedNttPlan(fr, n, self.comm.size, self.comm.rank, dev)
        _, h_std = compute_h(self.plan, ca, cb, cc,
                             None if self.comm is None else self._sharded_dft)
        del ca, cb, cc
        sync_device(dev)
        leave_block(self.h_block)

        enter_block("scalar from_monty (device)")
        w_keys = from_monty_keys(self.fr_ctx, w_mont)  # (24, wl)
        del w_mont
        sync_device(dev)
        leave_block("scalar from_monty (device)")

        if self.tables is not None:
            return self._assemble(inputs.r,
                                  *self._msms_with_tables(w_keys, h_std))

        enter_block(self.msm_block)
        # ONE fused G1 pass for A / B1 / L / H: the MSM index rides the
        # sort key, so the four MSMs share one sort / scan / reduction
        w = w_keys[:, self.keys_w]
        g1_keys = pad_keys([w, w, w_keys[:, self.keys_l],
                            h_std[:, self.keys_h]], self.n_pad)
        b2_keys = pad_keys([w], self.n2_pad)
        del w, w_keys, h_std
        ws_g1 = self._msm(self.g1, g1_keys, self.g1_rows, self.seg, 4)
        del g1_keys
        ws_b2 = self._msm(self.g2, b2_keys, self.b2_rows, None, 1)
        sync_device(dev)
        leave_block(self.msm_block)

        enter_block("readback + host assembly")
        At, Bt1, Lt, Ht = finalize_windows(self.g1, self.hg1, ws_g1, c, 4)
        Bt2, = finalize_windows(self.g2, self.hg2, ws_b2, c)
        return self._assemble(inputs.r, At, Bt1, Lt, Ht, Bt2)

    def _sharded_dft(self, x, inverse: bool):
        return sharded_ntt(self.plan, x, inverse, self.comm.group)

    def _msm(self, cops, keys, rows, seg, num: int):
        """Window sums of `num` fused MSMs on this rank's rows; over a
        group, the ranks' sums combined."""
        if self.comm is None:
            return msm_window_sums_streamed(
                cops, keys, rows, self.chunk_s, self.c, seg, num,
                self.block_points, self.signed)
        return sharded_msm_window_sums(
            cops, keys, rows, self.chunk_s, self.c, seg, num, self.signed,
            self.comm.group, block_points=self.block_points)

    def _msms_with_tables(self, w_keys, h_std):
        """The MSMs of the table path (tpu_prover.prove with tables,
        cuda_prover_piecewise.cu:162-187) and their readback: the host
        points (At, Bt1, Lt, Ht, Bt2) inside the readback block."""
        c, hg1, hg2 = self.c, self.hg1, self.hg2
        enter_block("MSMs (device: Straus tables + Pippenger A/H)")
        g1_keys = pad_keys([w_keys[:, self.keys_w], h_std[:, self.keys_h]],
                           self.n_pad)
        ws_g1 = self._msm(self.g1, g1_keys, self.g1_rows, self.seg, 2)
        del g1_keys, h_std
        B1_t, B2_t, L_t = self.tables
        w_all = w_keys[:, self.keys_w].contiguous()
        ws_B1 = straus_window_sums(self.g1, w_all, B1_t)
        ws_L = straus_window_sums(
            self.g1, w_keys[:, self.keys_l].contiguous(), L_t)
        ws_B2 = straus_window_sums(self.g2, w_all, B2_t)
        sync_device(self.device)
        leave_block("MSMs (device: Straus tables + Pippenger A/H)")

        enter_block("readback + host assembly")
        At, Ht = finalize_windows(self.g1, hg1, ws_g1, c, 2)
        Bt1, = finalize_windows(self.g1, hg1, ws_B1, STRAUS_C)
        Lt, = finalize_windows(self.g1, hg1, ws_L, STRAUS_C)
        Bt2, = finalize_windows(self.g2, hg2, ws_B2, STRAUS_C)
        return At, Bt1, Lt, Ht, Bt2

    def _assemble(self, r: int, At, Bt1, Lt, Ht, Bt2):
        """C = Ht + Lt + r * Bt1 and the affine (A, B2, C): the end of
        the readback block on every path."""
        hg1 = self.hg1
        C = hg1.add(hg1.add(Ht, Lt), hg1.mul(r, Bt1))
        out = (hg1.to_affine(At), self.hg2.to_affine(Bt2), hg1.to_affine(C))
        leave_block("readback + host assembly")
        return out


def prove(curve: CurveParams, params: DeviceParams, inputs: DeviceInput,
          device="cuda", tables=None):
    """Full proof as a one-shot session; returns affine (A, B2, C).
    `tables`: optional (B1_t, B2_t, L_t) for the table path (see
    ProverSession); proof bytes are the same either way."""
    return ProverSession(curve, params, device, tables).prove(inputs)


def prove_files(curve: CurveParams, params_path: str, input_path: str,
                output_path: str, device="cuda") -> None:
    """`gpu <CURVE> compute params input output`, with the phase-timer
    labels of the reference's print_time calls
    (cuda_prover_piecewise.cu:143-208), each timed by its span: the
    request is the root span "files.compute" (utils/profiling.py)."""
    with span("files.compute", root=True) as total:
        with span("files.load_params") as sp:
            params = load_params(params_path, curve)
        print(f"load params: {sp.seconds:.3f}s", flush=True)
        # the reference always loads `<CURVE>_preprocessed` from the
        # working directory (cuda_prover_piecewise.cu:244-247); here the
        # tables are optional and taken when the file is there
        tables = None
        pre_path = os.environ.get("GROTH16_PREPROCESSED_PATH",
                                  f"{curve.name}_preprocessed")
        if os.path.isfile(pre_path):
            with span("files.load_preprocessing") as sp:
                tables = load_preprocessed(pre_path, curve, params.m,
                                           params.L.shape[0])
            print(f"load preprocessing: {sp.seconds:.3f}s", flush=True)
        with span("files.load_inputs") as sp:
            inputs = load_input(input_path, curve, params.d, params.m)
        print(f"load inputs: {sp.seconds:.3f}s", flush=True)
        t = time.perf_counter()
        proof = prove(curve, params, inputs, device=device, tables=tables)
        print(f"prove (gpu e2e): {time.perf_counter() - t:.3f}s", flush=True)
        log_device_memory("post-prove")
        with span("files.store") as sp:
            ser.write_output(output_path, curve, *proof)
        print(f"store: {sp.seconds:.3f}s", flush=True)
    print(f"total: {total.seconds:.3f}s", flush=True)


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
    table file is not read.  Each pair is the root span "files.serve"
    (utils/profiling.py); the load and the staging join the first pair's
    record."""
    curve = CURVES[curve_name]
    t0 = time.perf_counter()
    with span("files.load_params") as sp:
        params = load_params(params_path, curve)
    print(f"load params: {sp.seconds:.3f}s", flush=True)
    t = time.perf_counter()
    sess = ProverSession(curve, params, device)
    print(f"stage params: {time.perf_counter() - t:.3f}s", flush=True)
    for i, (input_path, output_path) in enumerate(pairs):
        with span("files.serve", root=True):
            with span("files.load_inputs") as sp:
                inputs = load_input(input_path, curve, params.d, params.m)
            print(f"[{i}] load inputs: {sp.seconds:.3f}s", flush=True)
            t = time.perf_counter()
            proof = sess.prove(inputs)
            print(f"[{i}] prove (serve): {time.perf_counter() - t:.3f}s",
                  flush=True)
            with span("files.store"):
                ser.write_output(output_path, curve, *proof)
    log_device_memory("post-serve")
    print(f"total: {time.perf_counter() - t0:.3f}s", flush=True)
