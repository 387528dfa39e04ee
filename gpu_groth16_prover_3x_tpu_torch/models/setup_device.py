"""The trusted setup (generate_parameters) with its exponentiations on the
device.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/models/
setup_device.py, function for function.  The reference generator spends
its time in fixed-base exponentiations over G1 and G2 (libff batch_exp,
multiexp.tcc:587-680, driven by r1cs_gg_ppzksnark.tcc:289-345); the host
oracle (host/groth16.setup) runs them in Python and C++, this module on
the group kernels (ops/group_kernels.py):

  * windowed (n >= 32): one projective table T[w*2^8 + d] = d*2^(8w)*base
    per base, 96 windows x 256 multiples: the 96 window bases are host
    doublings, the multiples d = 1..255 are 255 ec_mixed_add launches of
    width 96 and d = 0 is the identity (0 : 1 : 0), which the complete
    add absorbs with no mask.  A scalar then costs 96 complete adds: each
    step gathers the table columns w*256 + digit of all n scalars and runs
    one ec_add of width n.
  * scan (n < 32, or GROTH16_EXP_WINDOWED=0): double and add over the 768
    bits, most significant first: ec_dbl, ec_mixed_add with the base, and
    a select on the bit.

The projective results are normalised on the device (ops/inverse.
to_affine_rows, the identity as the all-zero row) and come back as the
affine word rows of the parameter file, so a 2^20 query never becomes a
list of Python points.  Only group elements matter for the file, so the
bytes equal the host oracle's.

Checkpoints: with $GROTH16_SETUP_CACHE set, each query's rows are saved
there (.npy, written to a temporary name and moved into place), keyed by
the sha256 of repr((curve, group, affine base, n, scalars)); a query of
more than $GROTH16_EXP_BLOCK (default 16384) scalars runs, and is cached,
in blocks of that many, so a crashed run resumes at its last block.  As
in the JAX package, a block below 32 scalars takes the scan path.
"""

import hashlib
import os
import random
from typing import Sequence

import numpy as np
import torch

from ..curves.constants import R, CurveParams
from ..host import ec as host_ec
from ..host.fft import Radix2Domain
from ..host.groth16 import SetupResult, Trapdoor, qap_instance_evaluation
from ..host.r1cs import evaluate_lc, generate_r1cs_example_with_field_input
from ..ops import group_kernels
from ..ops import limbs as L
from ..ops.ec import get_curve_ops
from ..ops.inverse import to_affine_rows
from ..ops.msm import identity_words
from ..utils.profiling import enter_block, leave_block
from .gpu_prover import DeviceInput, DeviceParams
from .preprocess_device import affine_operand

EXP_WINDOW_C = 8                     # bits per window
NWIN = L.R_BITS // EXP_WINDOW_C      # 96 windows of a 768-bit scalar
WINDOWED_FROM = 32                   # fewer scalars take the scan path
_TABLE_CACHE = {}   # (curve, group, affine base, device) -> window table


def host_group(curve: CurveParams, group: str):
    return host_ec.g1_group(curve) if group == "g1" else \
        host_ec.g2_group(curve)


def affine_rows(curve: CurveParams, deg: int, points) -> np.ndarray:
    """Host affine points ((0, 0) for the identity) -> (n, 2*deg*24)
    int32 rows of Montgomery words, the parameter file's layout."""
    p = curve.fq.p
    vals = []
    for x, y in points:
        vals += [x, y] if deg == 1 else [*x, *y]
    words = L.ints_to_words([v * R % p for v in vals])
    return np.ascontiguousarray(words.T).reshape(len(points),
                                                 2 * deg * L.NWORDS)


def scalar_words(curve: CurveParams, scalars: Sequence[int]) -> np.ndarray:
    """Scalars reduced mod r -> (24, n) int32 standard-domain words."""
    r = curve.fr.p
    return L.ints_to_words([int(s) % r for s in scalars])


def params_from_host(curve: CurveParams, hp) -> DeviceParams:
    """Host-int Groth16Params (affine points, the zero as (0, 0)) -> word
    rows, the bytes load_params reads from the file write_params writes
    (the counterpart of the JAX package's tpu_prover.params_from_host)."""
    deg = curve.ext_degree
    return DeviceParams(hp.d, hp.m, *(
        affine_rows(curve, k, pts) for k, pts in
        ((1, hp.A), (1, hp.B1), (deg, hp.B2), (1, hp.L), (1, hp.H))))


def input_from_host(curve: CurveParams, hi) -> DeviceInput:
    """Host-int Groth16Input (standard-domain scalars) -> Montgomery word
    rows (count, 24), as load_input reads them from write_input's file."""
    r = curve.fr.p

    def rows(vals):
        return np.ascontiguousarray(L.ints_to_words(
            [v * R % r for v in vals]).T)
    return DeviceInput(rows(hi.w), rows(hi.ca), rows(hi.cb), rows(hi.cc),
                       hi.r)


def _window_table(curve: CurveParams, group: str, base_pt, device
                  ) -> torch.Tensor:
    """The (3*deg, 24, 96*256) projective table, column w*256 + d holding
    d * 2^(8w) * base (libff get_window_table, multiexp.tcc:547-585).
    Cached per (curve, group, base, device): the four G1 queries of a
    setup share one table."""
    cops = get_curve_ops(curve, group)
    hg = host_group(curve, group)
    key = (curve.name, group, hg.to_affine(base_pt), str(device))
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    # host: the 96 window bases 2^(8w) * base
    cur, bases = base_pt, []
    for _ in range(NWIN):
        bases.append(hg.to_affine(cur))
        for _ in range(EXP_WINDOW_C):
            cur = hg.dbl(cur)
    xy, inf = affine_operand(cops, affine_rows(curve, cops.deg, bases),
                             device)
    # device: the ladder d -> d + 1 over all windows at once
    acc = identity_words(cops, NWIN, device)
    ladder = [acc]
    for _ in range((1 << EXP_WINDOW_C) - 1):
        acc = group_kernels.ec_mixed_add(cops, acc, xy, inf)
        ladder.append(acc)
    table = torch.stack(ladder, -1).reshape(3 * cops.deg, L.NWORDS,
                                            NWIN << EXP_WINDOW_C)
    _TABLE_CACHE[key] = table
    return table


def _exp_windowed(cops, table: torch.Tensor, keys: torch.Tensor
                  ) -> torch.Tensor:
    """sum_w T[w, digit_w]: 96 gathers and complete adds of width n.  The
    8-bit digits, least significant first, are those of the JAX package's
    _digits_from_limbs: four to a 32-bit word."""
    words = keys.to(torch.int64) & 0xFFFFFFFF
    per = 32 // EXP_WINDOW_C
    acc = identity_words(cops, keys.shape[1], keys.device)
    for w in range(NWIN):
        digit = (words[w // per] >> (EXP_WINDOW_C * (w % per))) & 0xFF
        pt = table.index_select(2, digit + (w << EXP_WINDOW_C)).contiguous()
        acc = group_kernels.ec_add(cops, acc, pt)
    return acc


def _exp_scan(cops, xy: torch.Tensor, inf: torch.Tensor,
              keys: torch.Tensor) -> torch.Tensor:
    """Double and add over the 768 scalar bits, most significant first;
    xy (2*deg, 24, 1) is the affine base, inf its (1,) infinity flag."""
    n = keys.shape[1]
    xy = xy.expand(-1, -1, n).contiguous()
    inf = inf.expand(n).contiguous()
    words = keys.to(torch.int64) & 0xFFFFFFFF
    acc = identity_words(cops, n, keys.device)
    for i in range(L.R_BITS - 1, -1, -1):
        acc = group_kernels.ec_dbl(cops, acc)
        added = group_kernels.ec_mixed_add(cops, acc, xy, inf)
        acc = torch.where(((words[i // 32] >> (i % 32)) & 1).bool(), added,
                          acc)
    return acc


def _exp_cache_path(curve: CurveParams, group: str, base_aff, scalars):
    """A query's checkpoint under $GROTH16_SETUP_CACHE, or None."""
    d = os.environ.get("GROTH16_SETUP_CACHE")
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    h = hashlib.sha256(repr(
        (curve.name, group, base_aff, len(scalars), tuple(scalars))
    ).encode()).hexdigest()[:24]
    return os.path.join(d, f"exp-{curve.name}-{group}-{h}.npy")


def _exp_cache_save(cache_path, rows: np.ndarray) -> np.ndarray:
    if cache_path:
        tmp = f"{cache_path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, rows)
        os.replace(tmp, cache_path)
    return rows


def batch_exp_device(curve: CurveParams, group: str, base_pt,
                     scalars: Sequence[int], device="cuda") -> np.ndarray:
    """[s * base for s in scalars] (base a host Jacobian point) as the
    (n, 2*deg*24) int32 affine rows of the parameter file."""
    cops = get_curve_ops(curve, group)
    hg = host_group(curve, group)
    n = len(scalars)
    base_aff = hg.to_affine(base_pt)
    cache_path = _exp_cache_path(curve, group, base_aff, scalars)
    if cache_path and os.path.isfile(cache_path):
        return np.load(cache_path)
    blk = int(os.environ.get("GROTH16_EXP_BLOCK", 16384))
    if cache_path and n > blk:
        rows = np.concatenate([
            batch_exp_device(curve, group, base_pt, scalars[lo:lo + blk],
                             device) for lo in range(0, n, blk)])
        return _exp_cache_save(cache_path, rows)
    if n == 0:
        return np.zeros((0, 2 * cops.deg * L.NWORDS), np.int32)

    dev = torch.device(device)
    keys = torch.from_numpy(scalar_words(curve, scalars)).to(dev)
    windowed = (os.environ.get("GROTH16_EXP_WINDOWED", "1") != "0"
                and n >= WINDOWED_FROM)
    if windowed:
        P = _exp_windowed(cops, _window_table(curve, group, base_pt, dev),
                          keys)
    else:
        xy, inf = affine_operand(
            cops, affine_rows(curve, cops.deg, [base_aff]), dev)
        P = _exp_scan(cops, xy, inf, keys)
    del keys
    rows = to_affine_rows(cops, P).cpu().numpy()
    return _exp_cache_save(cache_path, rows)


def input_vectors(cs, full_assignment, r_mod: int, d_plus_1: int):
    """The input file's w, ca, cb, cc (generate_parameters.cpp:41-57)."""
    w = [1] + [x % r_mod for x in full_assignment]
    ca = [0] * d_plus_1
    cb = [0] * d_plus_1
    cc = [0] * d_plus_1
    for i in range(cs.num_inputs + 1):
        ca[i + cs.num_constraints] = (
            1 if i == 0 else full_assignment[i - 1] % r_mod)
    for i, cons in enumerate(cs.constraints):
        ca[i] = (ca[i] + evaluate_lc(cons.a, full_assignment, r_mod)) % r_mod
        cb[i] = (cb[i] + evaluate_lc(cons.b, full_assignment, r_mod)) % r_mod
        cc[i] = (cc[i] + evaluate_lc(cons.c, full_assignment, r_mod)) % r_mod
    return w, ca, cb, cc


def setup(curve: CurveParams, log2_d: int, rng: random.Random = None,
          device="cuda"):
    """generate_paramaters (libsnark/generate_parameters.cpp:23-123) with
    the five query exponentiations on `device`.  Draws from `rng` exactly
    as host/groth16.setup does: the R1CS, then t, alpha, beta, delta,
    g1_dlog, r and gamma last.  Returns (DeviceParams word rows for
    serialization.write_params_rows, SetupResult whose query lists are
    None: the points are in the rows)."""
    rng = rng or random.Random()
    dev = torch.device(device)
    torch.empty(0, device=dev)          # no card: fail before the host part
    r_mod = curve.fr.p
    d_plus_1 = 1 << log2_d
    d = d_plus_1 - 1

    enter_block("setup host part (R1CS, QAP, scalar vectors)")
    cs, primary, auxiliary = generate_r1cs_example_with_field_input(
        r_mod, d - 1, 1, rng)
    full_assignment = primary + auxiliary
    m = cs.num_variables

    cs.swap_ab_if_beneficial()
    t = rng.randrange(1, r_mod)
    alpha = rng.randrange(1, r_mod)
    beta = rng.randrange(1, r_mod)
    delta = rng.randrange(1, r_mod)
    delta_inv = pow(delta, -1, r_mod)

    domain = Radix2Domain(curve.fr, cs.num_constraints + cs.num_inputs + 1)
    at, bt, ct, zt = qap_instance_evaluation(cs, domain, t)
    lt = [(beta * at[i] + alpha * bt[i] + ct[i]) * delta_inv % r_mod
          for i in range(cs.num_inputs + 1, m + 1)]
    zt_dinv = zt * delta_inv % r_mod
    ht, ti = [], 1
    for _ in range(d):
        ht.append(ti * zt_dinv % r_mod)
        ti = ti * t % r_mod

    g1 = host_ec.g1_group(curve)
    g1_dlog = rng.randrange(1, r_mod)
    g1_gen = g1.mul(g1_dlog, host_ec.g1_generator(curve))
    g2_gen = host_ec.g2_generator(curve)
    w, ca, cb, cc = input_vectors(cs, full_assignment, r_mod, d_plus_1)
    r = rng.randrange(r_mod)
    # drawn LAST so the params/input byte streams match pre-vk setups
    gamma = rng.randrange(1, r_mod)
    leave_block("setup host part (R1CS, QAP, scalar vectors)")

    rows = {}
    for name, group, gen, scalars in (
            ("A", "g1", g1_gen, at), ("B1", "g1", g1_gen, bt),
            ("B2", "g2", g2_gen, bt), ("L", "g1", g1_gen, lt),
            ("H", "g1", g1_gen, ht)):
        enter_block(f"batch_exp {name} (device)")
        rows[name] = batch_exp_device(curve, group, gen, scalars, dev)
        leave_block(f"batch_exp {name} (device)")

    result = SetupResult(
        d=d, m=m, A=None, B1=None, B2=None, L=None, H=None,
        w=w, ca=ca, cb=cb, cc=cc, r=r,
        trapdoor=Trapdoor(t, alpha, beta, delta, g1_dlog, at, bt, ct, zt,
                          gamma),
    )
    return DeviceParams(d, m, **rows), result
