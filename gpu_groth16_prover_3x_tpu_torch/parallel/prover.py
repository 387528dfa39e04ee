"""The multi-device Groth16 prove step: points-sharded MSMs and the
domain-sharded H pipeline.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/parallel/prover.py,
the distributed composition of models/gpu_prover.py.  Each rank of the
group owns a contiguous slice of the witness, [lo, hi), and a slice of
the NTT domain, [rank*n/D, (rank+1)*n/D), and stages only what goes with
them: the w_mont rows and the ca / cb / cc columns of its slices, and
the query rows whose scalars it owns (A, B1 and B2 rows lo..hi, L rows
lo-2..hi-2, H rows of its domain slice).  Then, with no exchange but the
NTT's transposes and one gather a MSM:

  H pipeline (ops/ntt.compute_h on parallel/sharded.sharded_ntt)
  -> witness keys out of Montgomery form (its slice)
  -> one fused 4-way G1 MSM and one G2 MSM on its rows
     (parallel/sharded.sharded_msm_window_sums: local Pippenger, window
     sums gathered and combined on every rank)
  -> the host epilogue (ops/msm.finalize_windows), C = Ht + Lt + r * Bt1.

Every rank returns the same affine (A, B2, C), whose serialisation is
byte-identical to models/gpu_prover.prove's: an MSM is a sum, however its
points are split.
"""

import time

import numpy as np
import torch

from ..curves.constants import CurveParams
from ..host import ec as host_ec
from ..models.gpu_prover import (PI1, STREAM_ABOVE, STREAM_BLOCK,
                                 DeviceInput, DeviceParams, from_monty_keys,
                                 pad_rows, resolve_msm_cfg,
                                 resolve_resident_bytes, round_up,
                                 stage_rows, sync_device)
from ..ops import limbs as L
from ..ops.ec import get_curve_ops
from ..ops.msm import finalize_windows
from ..ops.ntt import compute_h
from ..utils.profiling import enter_block, leave_block
from . import multihost
from .sharded import (Comm, ShardedNttPlan, sharded_msm_window_sums,
                      sharded_ntt)


def _cols(rows: np.ndarray, count: int, device) -> torch.Tensor:
    """(k, 24) word rows -> (24, count) on the device, zero-padded."""
    out = np.zeros((L.NWORDS, count), dtype=np.int32)
    out[:, :rows.shape[0]] = rows.T
    return torch.from_numpy(out).to(device)


def prove_sharded(curve: CurveParams, params: DeviceParams,
                  inputs: DeviceInput, group=None, device=None,
                  block_points: int = None, resident_bytes=None,
                  verbose: bool = False):
    """One proof over the ranks of `group` (the default group, or one
    process); call it on every rank.  Returns affine (A, B2, C) host
    tuples on every rank.

    device: this rank's card by default (multihost.local_device), or
    "cpu".  The MSM configuration is models/gpu_prover.resolve_msm_cfg
    on the witness slice, the same on every rank, so the ranks' window
    sums combine.  block_points: stream each MSM in global blocks of that
    many points (sharded_msm_window_sums); by default only past
    STREAM_ABOVE rows a rank, in blocks of STREAM_BLOCK a rank.
    resident_bytes: as ProverSession's, on the rank's G1 and B2 rows;
    past it the rank's G1 rows stay in host memory and go up a block at
    a time (ops/msm.msm_window_sums_streamed), in global blocks of at
    most STREAM_BLOCK a rank, while its B2 rows stay on the device (as in
    the JAX package, parallel/prover.py:260-290).  Proof bytes depend on
    none of these."""
    t0 = time.time()
    comm = Comm(group)
    D, rank = comm.size, comm.rank
    dev = multihost.local_device(device)

    def log(msg):
        if verbose:
            print(f"[prove_sharded rank {rank}/{D} +{time.time() - t0:.2f}s]"
                  f" {msg}", flush=True)

    g1 = get_curve_ops(curve, "g1")
    g2 = get_curve_ops(curve, "g2")
    d, m = params.d, params.m
    n = d + 1
    # this rank's slices: witness [lo, hi) of m + 1 padded to D * wl, and
    # domain [hlo, hlo + nl); the H query has d = n - 1 rows
    wl = -(-(m + 1) // D)
    lo, hi = min(rank * wl, m + 1), min((rank + 1) * wl, m + 1)
    nl = n // D
    hlo = rank * nl
    l_lo, l_hi = max(lo, PI1), max(hi, PI1)     # L pairs row i with w[i+2]
    h_hi = min(hlo + nl, d)
    chunk_s, c, signed = resolve_msm_cfg(wl, dev)

    enter_block("stage params (host->device)")
    parts = [params.A[lo:hi], params.B1[lo:hi],
             params.L[l_lo - PI1:l_hi - PI1], params.H[hlo:h_hi]]
    n_tot = sum(len(a) for a in parts)
    n_pad = round_up(n_tot, chunk_s)
    n2_pad = round_up(hi - lo, chunk_s)
    row_bytes = 4 * (n_pad * params.A.shape[1] + n2_pad * params.B2.shape[1])
    resident = row_bytes <= resolve_resident_bytes(resident_bytes, dev)
    g1_rows = stage_rows(parts, n_pad, dev, resident)
    sizes = [len(a) for a in parts]
    sizes[-1] += n_pad - n_tot                   # padding joins MSM 3
    seg = torch.from_numpy(np.repeat(np.arange(4), sizes)
                           .astype(np.int64)).to(dev)
    b2_rows = torch.from_numpy(pad_rows(params.B2[lo:hi], n2_pad)).to(dev)
    if block_points is None and n_pad > STREAM_ABOVE:
        block_points = STREAM_BLOCK * D
    if not resident:
        block_points = min(block_points or STREAM_BLOCK * D,
                           STREAM_BLOCK * D)
    sync_device(dev)
    leave_block("stage params (host->device)")
    where = "on the device" if resident else "in host memory"
    log(f"staged G1 rows {n_pad} ({where}), G2 rows {n2_pad} (witness "
        f"[{lo}, {hi}), domain [{hlo}, {hlo + nl}))")

    enter_block("stage inputs (host->device)")
    ca, cb, cc = (_cols(a[hlo:hlo + nl], nl, dev)
                  for a in (inputs.ca, inputs.cb, inputs.cc))
    w_mont = _cols(inputs.w_mont[lo:hi], wl, dev)
    sync_device(dev)
    leave_block("stage inputs (host->device)")

    enter_block("H pipeline (sharded NTT)")
    splan = ShardedNttPlan(curve.fr, n, D, rank, dev)
    _, h_std = compute_h(splan, ca, cb, cc, lambda x, inverse: sharded_ntt(
        splan, x, inverse, group))
    del ca, cb, cc, splan
    sync_device(dev)
    leave_block("H pipeline (sharded NTT)")
    log("H pipeline done")

    enter_block("scalar from_monty (device)")
    w_keys = from_monty_keys(L.MontCtx(curve.fr.p), w_mont)
    del w_mont
    sync_device(dev)
    leave_block("scalar from_monty (device)")

    enter_block("MSMs (points-sharded Pippenger)")
    na = hi - lo
    g1_keys = torch.cat([
        w_keys[:, :na], w_keys[:, :na], w_keys[:, l_lo - lo:l_hi - lo],
        h_std[:, :h_hi - hlo],
        w_keys.new_zeros((L.NWORDS, n_pad - n_tot))], 1)
    b2_keys = torch.cat([w_keys[:, :na],
                         w_keys.new_zeros((L.NWORDS, n2_pad - na))], 1)
    del w_keys, h_std
    ws_g1 = sharded_msm_window_sums(g1, g1_keys, g1_rows, chunk_s, c, seg,
                                    4, signed, group,
                                    block_points=block_points)
    del g1_keys, g1_rows
    ws_b2 = sharded_msm_window_sums(g2, b2_keys, b2_rows, chunk_s, c, None,
                                    1, signed, group,
                                    block_points=block_points)
    sync_device(dev)
    leave_block("MSMs (points-sharded Pippenger)")
    log("MSMs combined")

    enter_block("readback + host assembly")
    hg1, hg2 = host_ec.g1_group(curve), host_ec.g2_group(curve)
    At, Bt1, Lt, Ht = finalize_windows(g1, hg1, ws_g1, c, 4)
    Bt2, = finalize_windows(g2, hg2, ws_b2, c)
    C = hg1.add(hg1.add(Ht, Lt), hg1.mul(inputs.r, Bt1))
    out = (hg1.to_affine(At), hg2.to_affine(Bt2), hg1.to_affine(C))
    leave_block("readback + host assembly")
    log("proof assembled")
    return out
