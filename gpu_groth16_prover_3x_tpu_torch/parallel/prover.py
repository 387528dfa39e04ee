"""The multi-device Groth16 prove step: points-sharded MSMs and the
domain-sharded H pipeline.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/parallel/prover.py.
Each rank of the group runs models/gpu_prover.ProverSession on its slice
(see its `comm`): it stages the witness, domain and query rows it owns,
and exchanges nothing but the NTT's transposes and one gather a MSM
(parallel/sharded.py).  Every rank returns the same affine (A, B2, C),
whose serialisation is byte-identical to models/gpu_prover.prove's: an
MSM is a sum, however its points are split.
"""

from ..curves.constants import CurveParams
from ..models.gpu_prover import DeviceInput, DeviceParams, ProverSession
from ..utils.profiling import span
from . import multihost
from .sharded import Comm


def prove_sharded(curve: CurveParams, params: DeviceParams,
                  inputs: DeviceInput, group=None, device=None,
                  block_points: int = None, resident_bytes=None):
    """One proof over the ranks of `group` (the default group, or one
    process); call it on every rank.  Returns affine (A, B2, C) host
    tuples on every rank.

    device: this rank's card by default (multihost.local_device), or
    "cpu".  block_points (global blocks over the ranks) and
    resident_bytes (on the rank's G1 and B2 rows) are ProverSession's.
    The session is staged and proved inside the root span "proof" of the
    rank's record (utils/profiling.py)."""
    with span("proof", root=True):
        sess = ProverSession(curve, params, multihost.local_device(device),
                             resident_bytes=resident_bytes,
                             block_points=block_points, comm=Comm(group))
        return sess._prove(inputs)
