"""Reference-compatible binary serialization (the part the prover needs).

The file format of the reference (libsnark/serialization.hpp):
  - field elements: 12 x u64 little-endian limbs of the Montgomery
    representation x*R mod p, R = 2^768 (:22-32)
  - G1 points: affine (x, y); the zero point is written as x=y=0 and
    recognized on read by y == 0 (:44-54, 84-91)
  - G2 points: affine (x, y), each coordinate an extension element
    written constant-coefficient first (:35-41, 56-67)
  - size_t: 8-byte little-endian (:113-121)

Files:
  params: d, m, A[m+1], B1[m+1], B2[m+1], L[m-1], H[d]
          (libsnark/generate_parameters.cpp:60-85)
  input:  w[m+1] (leading 1), ca[d+1], cb[d+1], cc[d+1], r
          (generate_parameters.cpp:88-107)
  output: A (G1), B (G2), C (G1)   (libsnark/main.cpp:79-85)

Bulk reads stay in the Montgomery domain: a file element's 12 u64 limbs
are exactly the port's 24 u32 words (the device radix R = 2^768 is the
file's), so loading is a bitcast with no modular arithmetic.
"""

import struct
import sys
from typing import BinaryIO, Tuple

import numpy as np

from ..curves.constants import R, CurveParams

FQ_BYTES = 96  # 12 limbs x 8 bytes


def _read_exact(f: BinaryIO, n: int) -> bytes:
    """Fail fast on short reads, like the reference's abort() on a short
    fread (multiexp/reduce.cu:203-205)."""
    b = f.read(n)
    if len(b) != n:
        raise EOFError(f"short read: wanted {n} bytes, got {len(b)}")
    return b


def check_trailing(f: BinaryIO, what: str) -> None:
    """Warn on bytes past the expected payload (the reference's
    check_trailing, cuda_prover_piecewise.cu:73-80)."""
    if f.read(1):
        print(f"gpu_groth16_prover_3x_tpu_torch: WARNING: trailing bytes in "
              f"{what} after the expected payload", file=sys.stderr,
              flush=True)


def read_size_t(f: BinaryIO) -> int:
    return struct.unpack("<Q", _read_exact(f, 8))[0]


def fq_to_bytes(x: int, p: int) -> bytes:
    """Standard-domain value -> Montgomery limb dump."""
    return ((x * R) % p).to_bytes(FQ_BYTES, "little")


def read_fq(f: BinaryIO, p: int) -> int:
    """Montgomery limb dump -> standard-domain value."""
    return int.from_bytes(_read_exact(f, FQ_BYTES), "little") * pow(R, -1, p) % p


def read_raw_u64(f: BinaryIO, count: int) -> np.ndarray:
    """`count` field elements as raw Montgomery limbs, shape (count, 12)."""
    arr = np.fromfile(f, dtype="<u8", count=count * 12)
    if arr.size != count * 12:
        raise EOFError("short read")
    return arr.reshape(count, 12)


def write_fq(f: BinaryIO, x: int, p: int) -> None:
    f.write(fq_to_bytes(x, p))


def write_fqe(f: BinaryIO, x: Tuple[int, ...], p: int) -> None:
    for c in x:
        write_fq(f, c, p)


def write_g1(f: BinaryIO, xy: Tuple[int, int], p: int) -> None:
    """`xy` is affine with zero encoded as (0, 0) (Group.to_affine)."""
    write_fq(f, xy[0], p)
    write_fq(f, xy[1], p)


def write_g2(f: BinaryIO, xy, p: int) -> None:
    write_fqe(f, xy[0], p)
    write_fqe(f, xy[1], p)


def write_output(path: str, curve: CurveParams, a_affine, b_affine,
                 c_affine) -> None:
    p = curve.fq.p
    with open(path, "wb") as f:
        write_g1(f, a_affine, p)
        write_g2(f, b_affine, p)
        write_g1(f, c_affine, p)
