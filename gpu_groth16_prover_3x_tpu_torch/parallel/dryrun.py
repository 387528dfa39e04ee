"""The ranks of the multi-device dryrun
(`dryrun_multichip` in __graft_entry_torch__.py at the repository root).

multihost.launch_local starts its ranks with the spawn start method and
pickles the rank function by name, so the function lives in the package,
which every rank imports whatever script started it.
"""

import time

from ..curves.constants import CURVES
from ..ops.group_kernels import EC_ADD, EC_DBL, EC_MIXED_ADD
from ..ops.mont_mul import MONT_MUL
from ..ops.msm import MSM_SCAN
from .prover import prove_sharded

COUNTERS = (MONT_MUL, EC_ADD, EC_DBL, EC_MIXED_ADD, MSM_SCAN)


def prove_rank(rank, curve_name, params, inputs, device) -> dict:
    """One rank: prove_sharded on the word rows it is given.  Returns the
    affine proof, its seconds and each kernel's launches in it (the
    counts set to 0 just before; 0 on the CPU, where no kernel runs)."""
    for k in COUNTERS:
        k.launches = 0
    t0 = time.perf_counter()
    proof = prove_sharded(CURVES[curve_name], params, inputs, device=device,
                          verbose=True)
    seconds = time.perf_counter() - t0
    return dict(rank=rank, proof=proof, seconds=seconds,
                launches={k.name: k.launches for k in COUNTERS})
