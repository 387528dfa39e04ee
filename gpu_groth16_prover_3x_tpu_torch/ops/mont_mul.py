"""Kernel 1: the batched Montgomery product (csrc/mont_mul.cu).

Replaces the TPU kernel `mont_mul_pallas` (gpu_groth16_prover_3x_tpu/
ops/pallas_kernels.py).  It carries every Fq and Fr multiply outside the
fused group kernels: the NTT / H pipeline, the witness keys out of
Montgomery form, and the NTT's table setup.

`mont_mul(ctx, a, b)` takes canonical (24, *B) int32 word tensors of one
shape and returns a*b/R mod p, canonical, same shape.  A CUDA tensor
launches the kernel; a CPU tensor runs the plain version, the CIOS of
ops/limbs.py on 24-bit limbs.  Nothing else falls back.  Both count
their lanes as `fp_mont_mul` (utils/opcount.py).
"""

import torch

from ..utils import opcount
from . import build
from . import limbs as L

MONT_MUL = build.Kernel("mont_mul")


def mont_mul_plain(ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """The plain PyTorch version: same function, same layout."""
    return L.from_limbs(L.mont_mul_limbs(ctx, L.to_limbs(a), L.to_limbs(b)))


def mont_mul(ctx: L.MontCtx, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    if a.shape != b.shape or a.shape[0] != L.NWORDS:
        raise ValueError(f"mont_mul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}, want equal (24, ...)")
    if a.device != b.device:
        raise ValueError("mont_mul: operands on different devices")
    opcount.add("fp_mont_mul", a.numel() // L.NWORDS)
    if a.device.type == "cpu":
        return mont_mul_plain(ctx, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul: unsupported device {a.device}")
    build.require(a, dtype=torch.int32, name="a")
    build.require(b, dtype=torch.int32, name="b")
    out = torch.empty_like(a)
    n = a.numel() // L.NWORDS
    build.check(build.library().g16_mont_mul(
        ctx.prime_id, a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
        build.stream_ptr(a)))
    MONT_MUL.launches += 1
    return out
