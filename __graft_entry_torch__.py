"""Entry points of the PyTorch/CUDA port: a one-card check of the
MSM step and a multi-device dryrun.

entry():             the G1 MSM window-sum step of the Groth16 prover
                     (ops/msm.msm_window_sums) and example arguments.
dryrun_multichip(n): run ONE full distributed prove step (points-parallel
                     MSMs + the four-step all-to-all NTT H pipeline) over n
                     torch.distributed ranks on tiny shapes and check it
                     against the exact host oracle proof.

The counterparts of __graft_entry__.py's functions (the JAX package).
Both run on the card unless the caller passes device="cpu".
"""

import random
import time

import torch

from gpu_groth16_prover_3x_tpu_torch.curves.constants import MNT4753
from gpu_groth16_prover_3x_tpu_torch.host import ec as host_ec
from gpu_groth16_prover_3x_tpu_torch.host import groth16 as host_groth16
from gpu_groth16_prover_3x_tpu_torch.models.setup_device import (
    affine_rows, input_from_host, params_from_host, scalar_words)
from gpu_groth16_prover_3x_tpu_torch.ops.ec import get_curve_ops
from gpu_groth16_prover_3x_tpu_torch.ops.msm import msm_window_sums
from gpu_groth16_prover_3x_tpu_torch.parallel.dryrun import prove_rank
from gpu_groth16_prover_3x_tpu_torch.parallel.multihost import (
    launch_local, local_device)
from gpu_groth16_prover_3x_tpu_torch.parallel.sharded import ntt_split
from gpu_groth16_prover_3x_tpu_torch.utils.serialization import (
    Groth16Input, Groth16Params)


def entry(device=None):
    """Returns (fn, example_args): the G1 MSM window-sum step on 128
    MNT4753 points, 8 bases tiled, and 128 random Fr scalars.

    fn(keys (24, 128) int32, rows (128, 48) int32) -> (3, 24, 96) int32
    projective window sums (c = 8, unsigned digits).  The arguments lie
    on this process's card, or on the CPU with device="cpu", where fn
    runs the kernels' plain versions; with no card and no "cpu" this
    raises."""
    dev = local_device(device)
    curve = MNT4753
    cops = get_curve_ops(curve, "g1")
    rng = random.Random(1234)
    hg = host_ec.g1_group(curve)
    gen = host_ec.g1_generator(curve)
    n = 128
    base = [hg.to_affine(hg.mul(3 + 5 * i, gen)) for i in range(8)]
    pts = [base[i % 8] for i in range(n)]
    rows = affine_rows(curve, 1, pts)
    keys = scalar_words(curve,
                        [rng.randrange(curve.fr.p) for _ in range(n)])

    def fn(keys, rows):
        # c=8 window: right-sized bucket reduction for the small example
        return msm_window_sums(cops, keys, rows, 16, 8)

    return fn, (torch.from_numpy(keys).to(dev),
                torch.from_numpy(rows).to(dev))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One distributed prove step over n_devices ranks, checked bit-exactly
    against the host oracle; returns its timings and each rank's
    proof, seconds and launches.

    The host setup (MNT4753, 2^6 domain up to 8 ranks, else 2^8; seed
    0xD15C) runs once, here; its points and scalars go to the ranks as
    word rows (params_from_host / input_from_host), and each rank, a
    process started by multihost.launch_local, runs
    parallel/prover.prove_sharded.  Every rank's proof must equal
    host/groth16.prove with no mask: all windows, with the prover's own
    window and digit kind (resolve_msm_cfg: c = 8 signed on a card, c = 4
    unsigned on the CPU).  A mismatch, or a rank that fails, raises.

    n_devices must be a power of two that divides both four-step factors
    of the domain (1, 2, 4, 8 or 16); any other raises ValueError before
    the host setup and before a process starts.  On the card (the
    default) each rank takes its own card over nccl when there are
    n_devices of them; otherwise the ranks share the card(s) (LOCAL_RANK
    % count) over gloo, since nccl refuses two ranks on one card.
    device="cpu" runs gloo ranks on the CPU, one torch thread each.

    The JAX dryrun's workarounds are gone: its 4-window mask
    (num_windows, the oracle's mask_bits), the XLA_FLAGS optimisation
    level, the persistent compile cache, GROTH16_DRYRUN_FULL and
    GROTH16_WB_SCAN all existed to bound XLA:CPU compile time, and the
    port compiles nothing per shape (the CUDA kernels build once)."""
    log2_d = 6 if n_devices <= 8 else 8
    n1, n2 = ntt_split(1 << log2_d)
    if n_devices < 1 or n_devices & (n_devices - 1) or n1 % n_devices \
            or n2 % n_devices:
        raise ValueError(f"dryrun_multichip: {n_devices} ranks; the NTT "
                         f"split needs one of [1, 2, 4, 8, 16]")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        one_each = (dev.index is None
                    and torch.cuda.device_count() >= n_devices)
        backend, threads = ("nccl" if one_each else "gloo"), None
    else:
        backend, threads = "gloo", 1

    t0 = time.time()
    curve = MNT4753
    print(f"dryrun_multichip({n_devices}): host setup (2^{log2_d} "
          f"domain)...", flush=True)
    res = host_groth16.setup(curve, log2_d, random.Random(0xD15C))
    hp = Groth16Params(res.d, res.m, res.A, res.B1, res.B2, res.L, res.H)
    hi = Groth16Input(res.w, res.ca, res.cb, res.cc, res.r)
    params = params_from_host(curve, hp)
    inputs = input_from_host(curve, hi)
    t1 = time.time()
    print(f"setup done ({t1 - t0:.1f}s); running the distributed prove "
          f"step on {n_devices} {backend} ranks ({dev.type})...", flush=True)

    ranks = launch_local(prove_rank, n_devices,
                         (curve.name, params, inputs, device),
                         backend=backend, device=device, threads=threads)
    t2 = time.time()
    print(f"distributed proof done ({t2 - t1:.1f}s); running host "
          f"oracle...", flush=True)
    expected = host_groth16.prove(curve, hp, hi)
    t3 = time.time()
    bad = [r["rank"] for r in ranks if r["proof"] != expected]
    if bad:
        raise AssertionError(f"dryrun_multichip({n_devices}): the proof of "
                             f"ranks {bad} != host oracle proof")
    print(f"dryrun_multichip({n_devices}): distributed proof == host "
          f"oracle (bit-exact, all windows) in {t3 - t0:.1f}s", flush=True)
    return dict(n_devices=n_devices, log2_d=log2_d, backend=backend,
                setup_s=t1 - t0, prove_s=t2 - t1, oracle_s=t3 - t2,
                total_s=t3 - t0, ranks=ranks)
