"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each compilation unit gets its own `nvcc` process, all started together,
to an object for sm_90a: `mont_mul.cu` and `ntt_addsub.cu` once, and
`group.cu` and `msm_scan.cu` once per group configuration (-DG16_CFG=0..3,
entry points `g16_ec_op_<cfg>` and `g16_msm_scan_<cfg>`; each
configuration fixes its own lanes per element at compile time,
csrc/field_coop.cuh), so the deg-3 tower code does not serialise the
build.  One link step makes `libg16kernels.so`, which is loaded with
ctypes (plain C entry points, no PyTorch headers).  The build runs at
first use into `_build/<hash>/` beside the package (listed in
.gitignore), keyed by the sources, the generated constants header and
the flags.  `-Xptxas -v` reports each
kernel's registers and spills; `ptxas_report()` returns that text and
`ptxas_summary()` the figures per kernel.

Every wrapper counts its launches in a `Kernel` object so that a run can
show that its main path went through the kernel.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..curves import constants as K

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("mont_mul.cu", "ntt_addsub.cu", "group.cu", "msm_scan.cu")
HEADERS = ("field.cuh", "field_coop.cuh")
CFGS = range(4)     # group configurations (ops/ec.py CurveOps.cfg)
UNITS = (("mont_mul.cu", None), ("ntt_addsub.cu", None),
         *(("group.cu", k) for k in CFGS),
         *(("msm_scan.cu", k) for k in CFGS))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")


class Kernel:
    """Launch counter of one kernel wrapper."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def _words_literal(x: int) -> str:
    w = [(x >> (32 * j)) & 0xFFFFFFFF for j in range(24)]
    return "{" + ", ".join(f"0x{v:08x}u" for v in w) + "}"


def constants_header() -> str:
    """Device constants, generated from curves/constants.py so the CUDA
    side cannot drift from the Python side.

    G16_P / G16_NINV / G16_ONE are indexed by prime id (0 = P_A, 1 = P_B).
    G16_B3 and G16_A are indexed by group config (0 = MNT4753 G1, 1 =
    MNT4753 G2, 2 = MNT6753 G1, 3 = MNT6753 G2): 3b for G1, and for G2
    the single nonzero coefficient c of 3*twist_b (MNT4753: (0, c);
    MNT6753: (c, 0, 0)); a for G1, and for G2 the single nonzero
    coefficient of twist_a (MNT4753: (26, 0); MNT6753: (0, 0, 11)); all
    in Montgomery form."""
    R = 1 << 768
    primes = (K.P_A, K.P_B)
    m4, m6 = K.MNT4753, K.MNT6753
    b3 = (3 * m4.b % K.P_B, 3 * m4.twist_b[1] % K.P_B,
          3 * m6.b % K.P_A, 3 * m6.twist_b[0] % K.P_A)
    b3_p = (K.P_B, K.P_B, K.P_A, K.P_A)
    a = (m4.a, m4.twist_a[0], m6.a, m6.twist_a[2])
    assert m4.twist_b[0] == 0 and m6.twist_b[1:] == (0, 0)
    assert m4.twist_a[1] == 0 and m6.twist_a[:2] == (0, 0)
    lines = ["// generated by ops/build.py from curves/constants.py",
             "#pragma once",
             "static __constant__ uint32_t G16_P[2][24] = {"
             + ", ".join(_words_literal(p) for p in primes) + "};",
             "static __constant__ uint32_t G16_NINV[2] = {"
             + ", ".join(f"0x{(-pow(p, -1, 1 << 32)) % (1 << 32):08x}u"
                         for p in primes) + "};",
             "static __constant__ uint32_t G16_ONE[2][24] = {"
             + ", ".join(_words_literal(R % p) for p in primes) + "};",
             "static __constant__ uint32_t G16_B3[4][24] = {"
             + ", ".join(_words_literal(v * R % p) for v, p in zip(b3, b3_p))
             + "};",
             "static __constant__ uint32_t G16_A[4][24] = {"
             + ", ".join(_words_literal(v * R % p) for v, p in zip(a, b3_p))
             + "};"]
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    # PyTorch's lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build_key(header: str, defs: tuple) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(header.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr((UNITS, defs)).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path, header: str, defs: tuple) -> None:
    nvcc = _nvcc()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    (tmp / "g16_constants.cuh").write_text(header)

    def compile_unit(unit):
        src, cfg = unit
        name = Path(src).stem + ("" if cfg is None else str(cfg))
        unit_defs = [] if cfg is None else [f"-DG16_CFG={cfg}", *defs]
        cmd = [nvcc, *NVCC_FLAGS, *unit_defs, "-I", str(tmp), "-I", str(CSRC),
               "-c", str(CSRC / src), "-o", str(tmp / (name + ".o"))]
        t0 = time.time()
        done = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return name, time.time() - t0, done

    # one nvcc process per unit, all started together
    with ThreadPoolExecutor(len(UNITS)) as pool:
        units = list(pool.map(compile_unit, UNITS))
    report = []
    failed = []
    objs = []
    for name, seconds, done in units:
        report.append(f"== {name} (nvcc {seconds:.1f} s)\n{done.stdout}")
        objs.append(str(tmp / (name + ".o")))
        if done.returncode != 0:
            failed.append(name)
    (tmp / "ptxas.txt").write_text("\n".join(report))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(report))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / "libg16kernels.so"), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    try:
        tmp.rename(out_dir)
    except OSError:
        # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)


def build_dir(defs: tuple = ()) -> Path:
    """The directory of the built library, building it at first use.
    `defs` are extra -D flags for the group and scan units: the tuning
    script (tune_lanes.py) compiles variants with them; the port
    itself always builds with none."""
    header = constants_header()
    out_dir = BUILD_ROOT / _build_key(header, tuple(defs))
    if not (out_dir / "libg16kernels.so").exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        _build(out_dir, header, tuple(defs))
    return out_dir


def load(out_dir: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry points."""
    lib = ctypes.CDLL(str(out_dir / "libg16kernels.so"))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.g16_mont_mul.argtypes = [i32, vp, vp, vp, i64, vp]
    lib.g16_mont_mul.restype = i32
    lib.g16_ntt_addsub.argtypes = [i32, i32, vp, vp, vp, vp,
                                   ctypes.POINTER(i64), vp]
    lib.g16_ntt_addsub.restype = i32
    for k in CFGS:
        ec = getattr(lib, f"g16_ec_op_{k}")
        ec.argtypes = [i32, vp, vp, vp, vp, i64, vp]
        scan = getattr(lib, f"g16_msm_scan_{k}")
        scan.argtypes = [vp, vp, vp, vp, i32, i64, vp, vp, vp, vp, vp, vp]
        tally = getattr(lib, f"g16_msm_scan_tally_{k}")
        tally.argtypes = [vp]
        ec.restype = scan.restype = tally.restype = i32
    lib.g16_error_string.argtypes = [i32]
    lib.g16_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    return load(build_dir())


def ptxas_report(defs: tuple = ()) -> str:
    """The build's nvcc/ptxas output (registers and spills per kernel)."""
    return (build_dir(defs) / "ptxas.txt").read_text()


def ptxas_summary(report: str) -> list:
    """(unit, kernel, registers, stack bytes, spill store bytes) per
    __global__ function of a ptxas report."""
    out, unit, kern, stack, spill = [], None, None, 0, 0
    for line in report.splitlines():
        if line.startswith("== "):
            unit = line.split()[1]
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kern = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kern:
            out.append((unit, kern, int(m.group(1)), stack, spill))
            kern = None
    return out


def check(err: int) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = library().g16_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, *, dtype, device=None, name="tensor") -> None:
    """Validate a tensor handed to a kernel."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
