"""Process-group wiring for the multi-device prover (torch.distributed).

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/parallel/multihost.py
(jax.distributed).  All compute lives in parallel/sharded.py and
parallel/prover.py; this file joins the process group and picks each
process's device.

On a cluster, one process per card under torchrun:

    torchrun --nproc-per-node 4 prove.py       # README "Several cards"

where prove.py calls `multihost.initialize()` and then
`prover.prove_sharded(...)`.  `initialize` reads torchrun's variables
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), the
counterparts of JAX_COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID.

`launch_local` runs a function in several spawned processes of one host
(a file store, no port): the tests' gloo ranks on the CPU and the smoke's
ranks on one card.
"""

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def local_device(device=None) -> torch.device:
    """This process's device: cuda:<LOCAL_RANK % device_count()>, unless
    the caller names one ("cpu", or a CUDA device with its index)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(backend=None, device=None, init_method=None,
               world_size=None, rank=None) -> torch.device:
    """Join the default process group and return this process's device.

    World size and rank come from the arguments, else from torchrun's
    WORLD_SIZE and RANK (init_method defaults to env://, which reads
    MASTER_ADDR and MASTER_PORT).  A no-op in one process (no world size
    given and no WORLD_SIZE set) and when the group exists.  The backend
    is the caller's choice, else nccl on a card and gloo on the CPU;
    several ranks on one card need gloo (nccl refuses them)."""
    dev = local_device(device)
    if dist.is_initialized():
        return dev
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return dev
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://", world_size=world_size,
        rank=rank)
    return dev


def data_group():
    """The group the prover shards over: the default group, or None in
    one process (the counterpart of data_mesh)."""
    return dist.group.WORLD if dist.is_initialized() else None


# -- several ranks on one host -------------------------------------------------

def _rank_main(fn, rank, world_size, store, backend, device, args, out,
               threads):
    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize(backend, device, f"file://{store}", world_size, rank)
        out.put((rank, True, fn(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _results(procs, out, timeout: float) -> list:
    """Each rank's result in rank order; raises on a rank's failure, on a
    rank that exits without a result and at the deadline."""
    results = {}
    deadline = time.monotonic() + timeout
    exited = False
    while len(results) < len(procs):
        try:
            rank, ok, payload = out.get(timeout=1.0)
        except queue.Empty:
            missing = [r for r in range(len(procs)) if r not in results]
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {missing} did not finish within "
                                   f"{timeout:.0f} s") from None
            dead = [r for r in missing if procs[r].exitcode is not None]
            if dead and exited:
                raise RuntimeError(
                    f"ranks {dead} exited without a result (exit codes "
                    f"{[procs[r].exitcode for r in dead]})") from None
            exited = bool(dead)      # one more wait drains the queue
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        results[rank] = payload
    return [results[r] for r in range(len(procs))]


def launch_local(fn, world_size: int, args=(), backend=None, device=None,
                 timeout: float = 900.0, threads=None) -> list:
    """Run fn(rank, *args) in `world_size` spawned processes of this
    host, each in one process group (a file store in a new temporary
    directory), and return their results in rank order.

    fn must be importable by name (the spawn start method); `device` and
    `backend` are handed to `initialize` in each rank, `threads` to
    torch.set_num_threads.  A rank that raises fails the call with its
    traceback, as does a rank without a result after `timeout` seconds;
    every process has ended when the call returns."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, world_size, os.path.join(tmp, "store"), backend,
            device, args, out, threads)) for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            results = _results(procs, out, timeout)
            for p in procs:
                p.join(60)
                if p.exitcode != 0:
                    raise RuntimeError(f"a rank exited with {p.exitcode} "
                                       f"after its result")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
    return results
