"""Rank functions of the multi-device tests (tests/test_torch_parallel.py
on the CPU, the card tests of tests/test_torch_gpu.py), run in spawned
processes by parallel/multihost.launch_local.  They import torch and the
port only, and return numpy arrays and plain values.  Run as a script, the
module is one rank of the README "Several cards" recipe on the CPU
(tests/test_torch_multihost.py)."""

import hashlib
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from gpu_groth16_prover_3x_tpu_torch.curves.constants import CURVES
from gpu_groth16_prover_3x_tpu_torch.models import gpu_prover as GP
from gpu_groth16_prover_3x_tpu_torch.ops import msm
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.ops.msm import combine_window_sums
from gpu_groth16_prover_3x_tpu_torch.parallel import multihost
from gpu_groth16_prover_3x_tpu_torch.parallel.prover import prove_sharded
from gpu_groth16_prover_3x_tpu_torch.parallel import sharded
from gpu_groth16_prover_3x_tpu_torch.parallel.sharded import (
    ShardedNttPlan, sharded_msm_window_sums, sharded_ntt)
from gpu_groth16_prover_3x_tpu_torch.utils import opcount
from gpu_groth16_prover_3x_tpu_torch.utils import serialization as ser

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port")


def ntt_rank(rank, curve_name, x_words, device):
    """This rank's shard of the forward and inverse sharded_ntt of the
    (24, n) vector x_words."""
    world = dist.get_world_size()
    dev = multihost.local_device(device)
    n = x_words.shape[1]
    plan = ShardedNttPlan(CURVES[curve_name].fr, n, world, rank, dev)
    nl = n // world
    x = torch.from_numpy(x_words[:, rank * nl:(rank + 1) * nl]).to(dev)
    return tuple(sharded_ntt(plan, x, inv).cpu().numpy()
                 for inv in (False, True))


def msm_rank(rank, curve_name, group, keys, rows, chunk_s, c, signed,
             block, device):
    """Window sums of the MSM of (keys (24, n), rows (n, F)), each global
    range of points split evenly over the ranks: one pass; global blocks
    of `block` points combined by combine_window_sums (both the same on
    every rank); and the pass with block_points=block and combine=False,
    the ranks' sums stacked.  numpy arrays."""
    world = dist.get_world_size()
    dev = multihost.local_device(device)
    cops = get_curve_ops(CURVES[curve_name], group)
    keys_t, rows_t = torch.from_numpy(keys).to(dev), \
        torch.from_numpy(rows).to(dev)

    def part(lo, hi):
        per = (hi - lo) // world
        a = lo + rank * per
        return keys_t[:, a:a + per].contiguous(), rows_t[a:a + per]

    n = rows.shape[0]
    one = sharded_msm_window_sums(cops, *part(0, n), chunk_s, c,
                                  signed=signed)
    acc = None
    for lo in range(0, n, block):
        ws = sharded_msm_window_sums(cops, *part(lo, lo + block), chunk_s, c,
                                     signed=signed)
        acc = ws if acc is None else combine_window_sums(cops, acc, ws)
    stacked = sharded_msm_window_sums(cops, *part(0, n), chunk_s, c,
                                      signed=signed, combine=False,
                                      block_points=block)
    return [t.cpu().numpy() for t in (one, acc, stacked)]


def prove_rank(rank, curve_name, device, params=None, inputs=None,
               block_points=None, resident_bytes=None):
    """prove_sharded of DeviceParams / DeviceInput (the committed fixture
    by default), streamed in global blocks of block_points when given,
    with resident_bytes; returns the affine proof, the proof file's
    sha256, this rank's op tally, its number of bucket-scan calls, where
    the rows of each of its two MSMs lay ("host" for numpy in host
    memory, else "device"), the arrays gpu_prover.stage_rows staged and
    the segment ids of each MSM (numpy, None for none) and, per MSM, the
    widths of its keys, rows and segment ids, its chunk and window, the
    global block it was given and the block the streamed MSM walked."""
    curve = CURVES[curve_name]
    if params is None:
        params = GP.load_params(os.path.join(
            FIX, f"{curve_name}-parameters"), curve)
        inputs = GP.load_input(os.path.join(FIX, f"{curve_name}-input"),
                               curve, params.d, params.m)
    scans = []
    scan = msm.msm_scan

    def counted(*args):
        scans.append(1)
        return scan(*args)
    msm.msm_scan = counted
    where, msms, staged, seg_ids = [], [], [], []
    sharded_msm = GP.sharded_msm_window_sums
    streamed = sharded.msm_window_sums_streamed
    stage_rows = GP.stage_rows

    def located(cops, keys, rows, chunk_s, c, seg, *args, **kwargs):
        where.append("host" if isinstance(rows, np.ndarray) else "device")
        msms.append(dict(keys=keys.shape[1], rows=rows.shape[0],
                         seg=None if seg is None else seg.shape[0],
                         chunk=chunk_s, c=c,
                         block_points=kwargs["block_points"]))
        seg_ids.append(None if seg is None else seg.cpu().numpy())
        return sharded_msm(cops, keys, rows, chunk_s, c, seg, *args,
                           **kwargs)

    def walked(cops, keys, rows, chunk_s, c, seg, num, block, *args):
        msms[-1]["walked"] = block
        return streamed(cops, keys, rows, chunk_s, c, seg, num, block, *args)

    def kept(*args):
        out = stage_rows(*args)
        staged.append(out if isinstance(out, np.ndarray) else
                      out.cpu().numpy())
        return out
    GP.sharded_msm_window_sums = located
    sharded.msm_window_sums_streamed = walked
    GP.stage_rows = kept
    try:
        with opcount.collect() as tally:
            proof = prove_sharded(curve, params, inputs, device=device,
                                  block_points=block_points,
                                  resident_bytes=resident_bytes)
    finally:
        msm.msm_scan = scan
        GP.sharded_msm_window_sums = sharded_msm
        sharded.msm_window_sums_streamed = streamed
        GP.stage_rows = stage_rows
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "proof")
        ser.write_output(out, curve, *proof)
        with open(out, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
    return dict(proof=proof, sha=sha, tally=tally, scans=len(scans),
                rows=where, msms=msms, staged=staged, seg_ids=seg_ids)


def one_rank_comm(rank):
    """A one-rank group's Comm on a small tensor: whether all_to_all gave
    back the tensor itself and all_gather a (1, ...) view of it, and the
    bytes counted as sent."""
    comm = sharded.Comm()
    x = torch.arange(12, dtype=torch.int32).reshape(1, 3, 4)
    with opcount.collect() as tally:
        a = comm.all_to_all(x)
        g = comm.all_gather(x[0])
    return (a is x, g.shape == x.shape and g.data_ptr() == x.data_ptr(),
            tally["all_to_all_bytes"], tally["all_gather_bytes"])


def failing_rank(rank):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


if __name__ == "__main__":
    # The README "Several cards" script with DEVICE = "cpu", one process a
    # rank under torchrun's variables (tests/test_torch_multihost.py):
    #   torch_parallel_ranks.py <CURVE> <params> <input> <output>
    DEVICE = "cpu"

    curve_name, params_path, input_path, output_path = sys.argv[1:5]
    multihost.initialize(device=DEVICE)      # nccl on cards, gloo on the CPU
    curve = CURVES[curve_name]
    params = GP.load_params(params_path, curve)
    inputs = GP.load_input(input_path, curve, params.d, params.m)
    proof = prove_sharded(curve, params, inputs, multihost.data_group(),
                          DEVICE)
    if dist.get_rank() == 0:
        ser.write_output(output_path, curve, *proof)
    dist.destroy_process_group()
