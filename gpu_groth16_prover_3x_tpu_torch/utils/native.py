"""ctypes bindings for the native host kernels (csrc/limb_host.cpp).

A copy of the JAX package's utils/native.py, with its own build: the
shared library is compiled on first use with g++ into the package's
`_build/` (listed in .gitignore), under a name keyed by the sha256 of the
source, written to a temporary name and moved into place with
os.replace, so processes that build at once each load a whole file.  It
exposes numpy-level batch operations:

  mont_mul_batch(a, b)        elementwise Montgomery products
  mont_encode / mont_decode   standard <-> Montgomery residue batches
  batch_affine(xs, ys, zs)    projective -> affine with ONE modular
                              inverse for the whole batch
  msm_jacobian, fixed_base_batch, fft_ints
                              the host oracle's MSM, fixed-base
                              exponentiation and FFT (host/msm.py,
                              host/fft.py)
  horner_proj                 the device MSM's window-sum recombination
                              (ops/msm.finalize_windows_native)

Every function has a pure-python fallback (or returns None for its
caller's) so the package still works where a compiler is unavailable.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "limb_host.cpp")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = ("-O3", "-shared", "-fPIC")

NL = 12
_U64P = ctypes.POINTER(ctypes.c_uint64)


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD, f"libgroth16host-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libgroth16host-", suffix=".so",
                               dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    try:
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.g16_mont_mul_batch.argtypes = [
            _U64P, _U64P, _U64P, ctypes.c_longlong, ctypes.c_longlong,
            _U64P, ctypes.c_uint64]
        lib.g16_batch_inv_prefix.argtypes = [
            _U64P, _U64P, ctypes.c_longlong, _U64P, ctypes.c_uint64]
        lib.g16_batch_inv_suffix.argtypes = [
            _U64P, _U64P, _U64P, _U64P, ctypes.c_longlong, _U64P,
            ctypes.c_uint64]
        lib.g16_mul_pairwise.argtypes = [
            _U64P, _U64P, _U64P, ctypes.c_longlong, _U64P, ctypes.c_uint64]
        lib.g16_msm.argtypes = [
            _U64P, _U64P, _U64P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, _U64P, ctypes.c_uint64, _U64P, _U64P]
        lib.g16_horner_proj.argtypes = [
            _U64P, _U64P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _U64P, ctypes.c_uint64, _U64P, _U64P]
        lib.g16_fixed_base_batch.argtypes = [
            _U64P, _U64P, _U64P, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, _U64P, ctypes.c_uint64, _U64P, _U64P]
        lib.g16_fft.argtypes = [
            _U64P, ctypes.c_longlong, _U64P, _U64P, _U64P, ctypes.c_uint64]
        lib.g16_vec_sub.argtypes = [
            _U64P, _U64P, _U64P, ctypes.c_longlong, _U64P]
        lib.g16_coset_scale.argtypes = [
            _U64P, ctypes.c_longlong, _U64P, _U64P, ctypes.c_uint64]
        for name in ("mont_mul_batch", "batch_inv_prefix", "batch_inv_suffix",
                     "mul_pairwise", "msm", "horner_proj", "fixed_base_batch",
                     "fft", "vec_sub", "coset_scale"):
            getattr(lib, f"g16_{name}").restype = None     # all void
        return lib
    except (OSError, subprocess.CalledProcessError):
        return None         # no compiler, or no loadable library: fallbacks


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U64P)


@lru_cache(maxsize=None)
def _field_consts(p: int) -> Tuple[np.ndarray, int, int, np.ndarray]:
    plimbs = np.frombuffer(p.to_bytes(96, "little"), dtype="<u8").copy()
    inv = (-pow(p, -1, 1 << 64)) % (1 << 64)
    r = (1 << 768) % p
    r2 = np.frombuffer(((r * r) % p).to_bytes(96, "little"),
                       dtype="<u8").copy()
    return plimbs, inv, r, r2


def _limbs_of(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(96, "little"), dtype="<u8").copy()


def _int_of(limbs: np.ndarray) -> int:
    return int.from_bytes(np.ascontiguousarray(
        limbs, dtype="<u8").tobytes(), "little")


def mont_mul_batch(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """(n,12)x(n,12) or (n,12)x(1,12) u64 Montgomery products."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype="<u8")
    b = np.ascontiguousarray(b, dtype="<u8")
    n = a.shape[0]
    plimbs, inv, _, _ = _field_consts(p)
    out = np.empty_like(a)
    stride = 0 if b.shape[0] == 1 else 1
    if lib is not None:
        lib.g16_mont_mul_batch(_ptr(out), _ptr(a), _ptr(b), n, stride,
                               _ptr(plimbs), inv)
        return out
    rinv = pow(1 << 768, -1, p)
    for i in range(n):
        v = _int_of(a[i]) * _int_of(b[i * stride]) * rinv % p
        out[i] = _limbs_of(v)
    return out


def mont_encode(std: np.ndarray, p: int) -> np.ndarray:
    """(n,12) standard residues -> Montgomery (multiply by R^2 / R)."""
    _, _, _, r2 = _field_consts(p)
    return mont_mul_batch(std, r2[None, :], p)


def mont_decode(mont: np.ndarray, p: int) -> np.ndarray:
    """(n,12) Montgomery -> standard residues (multiply by 1 / R)."""
    one = np.zeros((1, NL), dtype="<u8")
    one[0, 0] = 1
    return mont_mul_batch(mont, one, p)


def _ints_to_limbs(vals) -> np.ndarray:
    """List of ints (< 2^768) -> (n, 12) little-endian u64 rows."""
    buf = b"".join(int(v).to_bytes(96, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u8").reshape(len(vals), NL).copy()


def _limbs_to_ints(arr: np.ndarray) -> list:
    raw = np.ascontiguousarray(arr, dtype="<u8").tobytes()
    return [int.from_bytes(raw[i * 96:(i + 1) * 96], "little")
            for i in range(len(raw) // 96)]


def _flatten_coords(points, deg: int) -> list:
    """Jacobian points (X,Y,Z) with int (deg=1) or deg-tuple coords ->
    flat int list, 3*deg ints per point."""
    flat = []
    if deg == 1:
        for x, y, z in points:
            flat += [x, y, z]
    else:
        for x, y, z in points:
            flat += list(x) + list(y) + list(z)
    return flat


def _ec_consts(p: int, deg: int, alpha: int, a_coef) -> Tuple:
    """Montgomery-encoded (alpha, a) rows + field constants."""
    plimbs, inv, r, _ = _field_consts(p)
    alpha_m = _ints_to_limbs([(alpha % p) * r % p])
    a_list = [a_coef] if deg == 1 else list(a_coef)
    a_m = _ints_to_limbs([(int(c) % p) * r % p for c in a_list])
    return plimbs, inv, alpha_m, a_m


def msm_jacobian(p: int, deg: int, alpha: int, a_coef, points, scalars,
                 c: int):
    """Native Pippenger MSM over standard-domain int Jacobian points.

    Returns a Jacobian point in the same int representation; None when the
    native library is unavailable (callers fall back to Python).
    """
    lib = _load()
    if lib is None:
        return None
    plimbs, inv, alpha_m, a_m = _ec_consts(p, deg, alpha, a_coef)
    n = len(points)
    pts_std = _ints_to_limbs([v % p for v in _flatten_coords(points, deg)])
    pts = mont_encode(pts_std, p)
    sc = _ints_to_limbs([int(s) for s in scalars])
    out = np.empty((3 * deg, NL), dtype="<u8")
    lib.g16_msm(_ptr(out), _ptr(pts), _ptr(sc), n, c, deg, _ptr(plimbs),
                inv, _ptr(alpha_m), _ptr(a_m))
    coords = _limbs_to_ints(mont_decode(out, p))
    if deg == 1:
        return (coords[0], coords[1], coords[2])
    return (tuple(coords[0:deg]), tuple(coords[deg:2 * deg]),
            tuple(coords[2 * deg:3 * deg]))


def horner_proj(p: int, deg: int, alpha: int, a_coef,
                wsums_mont: np.ndarray, cbits: int):
    """Native window-sum recombination: sum_w 2^(cbits*w) * W_w.

    wsums_mont: (nwin, 3*deg*12) u64 HOMOGENEOUS-projective Montgomery
    rows, canonical (< p), zero encoded as Z == 0.  Returns a Jacobian
    int point (standard domain), or None when the library is missing.
    This replaces the pure-python Horner epilogue of the device prover
    (~12 s of a warm 2^16 proof; native it is milliseconds).
    """
    lib = _load()
    if lib is None:
        return None
    plimbs, inv, alpha_m, a_m = _ec_consts(p, deg, alpha, a_coef)
    ws = np.ascontiguousarray(wsums_mont, dtype="<u8")
    nwin = ws.shape[0]
    assert ws.shape[1] == 3 * deg * NL
    out = np.empty((3 * deg, NL), dtype="<u8")
    lib.g16_horner_proj(_ptr(out), _ptr(ws), nwin, cbits, deg,
                        _ptr(plimbs), inv, _ptr(alpha_m), _ptr(a_m))
    coords = _limbs_to_ints(mont_decode(out, p))
    if deg == 1:
        return (coords[0], coords[1], coords[2])
    return (tuple(coords[0:deg]), tuple(coords[deg:2 * deg]),
            tuple(coords[2 * deg:3 * deg]))


def fixed_base_batch(p: int, deg: int, alpha: int, a_coef, base, scalars,
                     window: int):
    """Native fixed-base windowed exponentiation: [s * base for s in
    scalars] as Jacobian int points (standard domain), or None."""
    lib = _load()
    if lib is None:
        return None
    plimbs, inv, alpha_m, a_m = _ec_consts(p, deg, alpha, a_coef)
    n = len(scalars)
    base_std = _ints_to_limbs([v % p for v in _flatten_coords([base], deg)])
    base_m = mont_encode(base_std, p)
    sc = _ints_to_limbs([int(s) for s in scalars])
    out = np.empty((n * 3 * deg, NL), dtype="<u8")
    lib.g16_fixed_base_batch(_ptr(out), _ptr(base_m), _ptr(sc), n, window,
                             deg, _ptr(plimbs), inv, _ptr(alpha_m),
                             _ptr(a_m))
    coords = _limbs_to_ints(mont_decode(out, p))
    pts = []
    for i in range(n):
        c0 = coords[i * 3 * deg:(i + 1) * 3 * deg]
        if deg == 1:
            pts.append((c0[0], c0[1], c0[2]))
        else:
            pts.append((tuple(c0[0:deg]), tuple(c0[deg:2 * deg]),
                        tuple(c0[2 * deg:3 * deg])))
    return pts


def fft_ints(a, omega: int, p: int):
    """Native in-place radix-2 NTT over standard-domain ints (list in,
    list out); None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    plimbs, inv, r, _ = _field_consts(p)
    arr = mont_encode(_ints_to_limbs([x % p for x in a]), p)
    omega_m = _ints_to_limbs([omega % p * r % p])
    one_m = _ints_to_limbs([r])
    lib.g16_fft(_ptr(arr), len(a), _ptr(omega_m), _ptr(one_m),
                _ptr(plimbs), inv)
    return _limbs_to_ints(mont_decode(arr, p))


def batch_affine(xs: np.ndarray, ys: np.ndarray, zs: np.ndarray,
                 p: int) -> Tuple[np.ndarray, np.ndarray]:
    """Montgomery-domain projective (X:Y:Z) rows -> affine (x, y) rows,
    with a single modular inversion for the whole batch.  Zero points
    (Z == 0) map to (0, 0) — the serialized-infinity convention."""
    lib = _load()
    xs = np.ascontiguousarray(xs, dtype="<u8")
    ys = np.ascontiguousarray(ys, dtype="<u8")
    zs = np.ascontiguousarray(zs, dtype="<u8")
    n = xs.shape[0]
    plimbs, inv, r, _ = _field_consts(p)
    if lib is None:
        rinv_ = pow(1 << 768, -1, p)
        ox = np.zeros_like(xs)
        oy = np.zeros_like(ys)
        for i in range(n):
            z = _int_of(zs[i]) * rinv_ % p
            if z == 0:
                continue
            zi = pow(z, -1, p)
            ox[i] = _limbs_of(_int_of(xs[i]) * zi % p)
            oy[i] = _limbs_of(_int_of(ys[i]) * zi % p)
        return ox, oy

    prefix = np.empty((n + 1, NL), dtype="<u8")
    prefix[0] = _limbs_of(r)                      # Montgomery one
    lib.g16_batch_inv_prefix(_ptr(prefix), _ptr(zs), n, _ptr(plimbs), inv)
    # one modular inverse on the host bigint; keep the Montgomery domain:
    # prefix[n] = R * prod(z_std); want total_inv = R * prod(z_std)^-1
    total_std = _int_of(prefix[n]) * pow(1 << 768, -1, p) % p
    total_inv = _limbs_of(pow(total_std, -1, p) * (1 << 768) % p)
    zinvs = np.empty_like(zs)
    lib.g16_batch_inv_suffix(_ptr(zinvs), _ptr(total_inv), _ptr(prefix),
                             _ptr(zs), n, _ptr(plimbs), inv)
    ox = np.empty_like(xs)
    oy = np.empty_like(ys)
    lib.g16_mul_pairwise(_ptr(ox), _ptr(xs), _ptr(zinvs), n,
                         _ptr(plimbs), inv)
    lib.g16_mul_pairwise(_ptr(oy), _ptr(ys), _ptr(zinvs), n,
                         _ptr(plimbs), inv)
    return ox, oy
