"""Reference-compatible binary serialization.

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
file's), so loading is a bitcast with no modular arithmetic, and
`write_params_rows` writes word rows back the same way.  The host-int
readers and writers (`read_params`, `read_input`, `write_params`,
`write_input`) serve the `cpu` oracle and the host setup; they are copies
of the JAX package's utils/serialization.py.
"""

import struct
import sys
from dataclasses import dataclass
from typing import BinaryIO, Tuple

import numpy as np

from ..curves.constants import R, CurveParams

FQ_BYTES = 96  # 12 limbs x 8 bytes


def write_size_t(f: BinaryIO, n: int) -> None:
    f.write(struct.pack("<Q", n))


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


def read_fqe(f: BinaryIO, p: int, deg: int) -> Tuple[int, ...]:
    return tuple(read_fq(f, p) for _ in range(deg))


def read_g1_affine(f: BinaryIO, p: int) -> Tuple[int, int]:
    x = read_fq(f, p)
    y = read_fq(f, p)
    return (x, y)  # y == 0 means the zero point (serialization.hpp:87)


def read_g2_affine(f: BinaryIO, p: int, deg: int):
    return (read_fqe(f, p, deg), read_fqe(f, p, deg))


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


# -- host-int file objects (the `cpu` oracle and the host setup) ------------------

@dataclass
class Groth16Params:
    """Mirror of the reference's groth16_parameters (libsnark/main.cpp:27-46)."""
    d: int
    m: int
    A: list      # m+1 affine G1
    B1: list     # m+1 affine G1
    B2: list     # m+1 affine G2
    L: list      # m-1 affine G1
    H: list      # d affine G1


@dataclass
class Groth16Input:
    """Mirror of groth16_input (libsnark/main.cpp:48-68)."""
    w: list      # m+1 scalars (standard domain)
    ca: list     # d+1
    cb: list     # d+1
    cc: list     # d+1
    r: int


def read_fq_vec(f: BinaryIO, count: int, p: int) -> list:
    """`count` Montgomery limb dumps -> standard-domain values (read_fq
    in bulk: one read, one inverse of R)."""
    raw = _read_exact(f, count * FQ_BYTES)
    rinv = pow(R, -1, p)
    return [int.from_bytes(raw[i:i + FQ_BYTES], "little") * rinv % p
            for i in range(0, len(raw), FQ_BYTES)]


def _read_points(f: BinaryIO, count: int, p: int, deg: int) -> list:
    """`count` affine points (G1 for deg 1, else G2 coordinates as
    deg-tuples); y == 0 means the zero point (serialization.hpp:87)."""
    v = read_fq_vec(f, count * 2 * deg, p)
    if deg == 1:
        return list(zip(v[0::2], v[1::2]))
    k = 2 * deg
    return [(tuple(v[i:i + deg]), tuple(v[i + deg:i + k]))
            for i in range(0, len(v), k)]


def read_params(path: str, curve: CurveParams) -> Groth16Params:
    p, deg = curve.fq.p, curve.ext_degree
    with open(path, "rb") as f:
        d = read_size_t(f)
        m = read_size_t(f)
        A = _read_points(f, m + 1, p, 1)
        B1 = _read_points(f, m + 1, p, 1)
        B2 = _read_points(f, m + 1, p, deg)
        L = _read_points(f, m - 1, p, 1)
        H = _read_points(f, d, p, 1)
        check_trailing(f, path)
    return Groth16Params(d, m, A, B1, B2, L, H)


def read_input(path: str, curve: CurveParams, d: int, m: int) -> Groth16Input:
    r_mod = curve.fr.p
    with open(path, "rb") as f:
        w = read_fq_vec(f, m + 1, r_mod)
        ca, cb, cc = (read_fq_vec(f, d + 1, r_mod) for _ in range(3))
        r = read_fq(f, r_mod)
        check_trailing(f, path)
    return Groth16Input(w, ca, cb, cc, r)


def write_params(path: str, curve: CurveParams, d: int, m: int,
                 A, B1, B2, L, H) -> None:
    """generate_parameters.cpp:60-85 layout (affine inputs)."""
    p = curve.fq.p
    with open(path, "wb") as f:
        write_size_t(f, d)
        write_size_t(f, m)
        assert len(A) == m + 1 and len(B1) == m + 1 and len(B2) == m + 1
        assert len(L) == m - 1 and len(H) == d
        for xy in A:
            write_g1(f, xy, p)
        for xy in B1:
            write_g1(f, xy, p)
        for xy in B2:
            write_g2(f, xy, p)
        for xy in L:
            write_g1(f, xy, p)
        for xy in H:
            write_g1(f, xy, p)


def write_params_rows(path: str, params) -> None:
    """The same layout from word rows: the exact inverse of
    models/gpu_prover.load_params.  `params` carries d, m and the (count,
    2*deg*24) int32 affine rows A, B1, B2, L, H (gpu_prover.DeviceParams),
    which are the file's bytes, so each query is one tofile."""
    d, m = params.d, params.m
    counts = {"A": m + 1, "B1": m + 1, "B2": m + 1, "L": m - 1, "H": d}
    with open(path, "wb") as f:
        write_size_t(f, d)
        write_size_t(f, m)
        for name, count in counts.items():
            rows = np.ascontiguousarray(getattr(params, name), dtype="<i4")
            if rows.shape[0] != count:
                raise ValueError(f"{name}: {rows.shape[0]} rows, want {count}")
            rows.tofile(f)


def write_input(path: str, curve: CurveParams, w, ca, cb, cc, r: int) -> None:
    """generate_parameters.cpp:88-107 layout (standard-domain scalars)."""
    rp = curve.fr.p
    with open(path, "wb") as f:
        for vec in (w, ca, cb, cc):
            f.write(b"".join(fq_to_bytes(x, rp) for x in vec))
        write_fq(f, r, rp)
