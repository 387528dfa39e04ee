"""Kernel 2: whole group operations (csrc/group.cu).

Replaces the TPU kernels `maybe_add` / `maybe_dbl` / `maybe_mixed_add`
(gpu_groth16_prover_3x_tpu/ops/pallas_group.py, `_build` / `_run`).  A
group of 4 (G1) or 8 (Fq2, Fq3) warp lanes runs one point's formula with
each field element spread over the lanes' registers
(csrc/field_coop.cuh).  On the main path `ec_add` and `ec_dbl` carry the
MSM's cross-chunk stitch, its boundary totals, the halving bucket
reduction and the streamed window-sum combine; `ec_mixed_add` exposes the
scan's inner operation for direct tests.

Points are (3*deg, 24, B) int32 word tensors (X coefficients, then Y, then
Z), canonical; affine operands (2*deg, 24, B); the infinity mask (B,)
bool.  A CUDA tensor launches the kernel; a CPU tensor runs the plain
version (ops/ec.py).  Nothing else falls back.  Both count their lanes
under the operation's name (utils/opcount.py).
"""

import torch

from ..utils import opcount
from . import build
from . import limbs as L
from .ec import CurveOps, from_limb_point, to_limb_point

EC_ADD = build.Kernel("ec_add")
EC_DBL = build.Kernel("ec_dbl")
EC_MIXED_ADD = build.Kernel("ec_mixed_add")


# -- plain versions ---------------------------------------------------------------

def ec_add_plain(cops: CurveOps, P, Q):
    d = cops.deg
    return from_limb_point(cops.add(to_limb_point(P, d), to_limb_point(Q, d)))


def ec_dbl_plain(cops: CurveOps, P):
    return from_limb_point(cops.dbl(to_limb_point(P, cops.deg)))


def ec_mixed_add_plain(cops: CurveOps, P, xy, inf):
    d = cops.deg
    a = to_limb_point(xy, d)
    return from_limb_point(cops.mixed_add(
        to_limb_point(P, d), a[:, 0], a[:, 1], inf))


# -- wrappers ------------------------------------------------------------------------

def _check_points(cops: CurveOps, *operands):
    """operands: (tensor, coordinate count) pairs sharing a device and a
    batch width; returns (on the card, batch width)."""
    dev, n = operands[0][0].device, operands[0][0].shape[-1]
    ts = [t for t, _ in operands]
    for t, ncoord in operands:
        if t.device != dev:
            raise ValueError("operands on different devices")
        want = (ncoord * cops.deg, L.NWORDS, n)
        if tuple(t.shape) != want:
            raise ValueError(f"point tensor shape {tuple(t.shape)}, want "
                             f"{want}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        for t in ts:
            build.require(t, dtype=torch.int32)
    return dev.type == "cuda", n


def _launch(op: int, cops: CurveOps, P, Q, inf, n: int):
    out = torch.empty_like(P)
    launch = getattr(build.library(), f"g16_ec_op_{cops.cfg}")
    build.check(launch(
        op, P.data_ptr(), None if Q is None else Q.data_ptr(),
        None if inf is None else inf.data_ptr(), out.data_ptr(), n,
        build.stream_ptr(P)))
    return out


def ec_add(cops: CurveOps, P, Q):
    """P + Q for two (3*deg, 24, B) point batches."""
    on_card, n = _check_points(cops, (P, 3), (Q, 3))
    opcount.add("ec_add", n)
    if not on_card:
        return ec_add_plain(cops, P, Q)
    out = _launch(0, cops, P, Q, None, n)
    EC_ADD.launches += 1
    return out


def ec_dbl(cops: CurveOps, P):
    on_card, n = _check_points(cops, (P, 3))
    opcount.add("ec_dbl", n)
    if not on_card:
        return ec_dbl_plain(cops, P)
    out = _launch(1, cops, P, None, None, n)
    EC_DBL.launches += 1
    return out


def ec_mixed_add(cops: CurveOps, P, xy, inf):
    """P + (x, y) for affine (2*deg, 24, B) operands; where inf (B,) bool
    is set the affine operand is the identity and the result is P."""
    on_card, n = _check_points(cops, (P, 3), (xy, 2))
    if inf.shape != (n,) or inf.dtype != torch.bool:
        raise ValueError("inf must be a (B,) bool tensor")
    opcount.add("ec_mixed_add", n)
    if not on_card:
        return ec_mixed_add_plain(cops, P, xy, inf)
    inf8 = inf.to(torch.uint8).contiguous()
    build.require(inf8, dtype=torch.uint8, device=P.device, name="inf")
    out = _launch(2, cops, P, xy, inf8, n)
    EC_MIXED_ADD.launches += 1
    return out
