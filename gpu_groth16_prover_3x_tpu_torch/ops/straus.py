"""Table-based windowed MSM (Straus) over preprocessed multiples.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/ops/straus.py: it
consumes the reference's `<CURVE>_preprocessed` tables, rows [P..],
[2P..], ..., [(2^C - 1)P..] with C = 5 (libsnark/main.cpp:248-339,
consumed at cuda_prover_piecewise.cu:125-141, kernel
multiexp/reduce.cu:11-76).

Per 5-bit window w of the scalars:
  1. the digit d_i of every scalar (`straus_digits`);
  2. gather table row (d_i - 1)*n + i; digit 0 and the table's all-zero
     rows (y == 0, the file's infinity) lift to the identity (0 : 1 : 0);
  3. tree-reduce the n lifted points with the group add kernel
     (group_kernels.ec_add): ceil(log2 n) halving levels, an odd lane
     riding up unchanged, so n needs no padding.
A block of windows runs as one wider batch, sized so that its projective
points stay under WINDOW_BYTES: the tree then costs ceil(log2 n) ec_add
launches per block instead of per window.

The window sums come back in the layout of msm_window_sums(num_msms=1)
and recombine on the host with the same Horner doubling as the Pippenger
path (finalize_msm with cbits=5).  The path does about three times the
group adds of the Pippenger scan and is expected to be slower; the
prover takes it only when a table file is present.

Scalars are (24, n) int32 standard-domain words; table rows are
((2^c - 1)*n, 2*deg*24) int32 affine Montgomery rows (x coefficients,
then y), row k*n + i = (k+1)*P_i.
"""

import torch

from . import limbs as L
from . import group_kernels
from .msm import finalize_msm, identity_words, window_sums_to_host

STRAUS_C = 5                  # window bits baked into the table format
SCALAR_BITS = 753
WINDOW_BYTES = 4 << 30        # projective points of one block of windows


def num_windows(c: int = STRAUS_C) -> int:
    return -(-SCALAR_BITS // c)


def window_block(deg: int, n: int, c: int = STRAUS_C) -> int:
    """Windows reduced as one batch for an n-point MSM over Fq^deg: as
    many as keep the batch's projective points under WINDOW_BYTES."""
    return max(1, min(num_windows(c),
                      WINDOW_BYTES // (n * 3 * deg * L.NWORDS * 4)))


def straus_digits(keys: torch.Tensor, c: int = STRAUS_C) -> torch.Tensor:
    """(24, n) scalar words -> (num_windows(c), n) int64 c-bit digits.

    Window w starts at bit c*w, in word (c*w) >> 5 at offset (c*w) & 31,
    and straddles into the next word when the offset is above 32 - c.
    Each window reads its word and the next as one 64-bit value; a zero
    25th word keeps the top window inside the array."""
    n = keys.shape[1]
    w = keys.to(torch.int64) & 0xFFFFFFFF
    w = torch.cat([w, w.new_zeros((1, n))])
    pos = torch.arange(num_windows(c), device=keys.device) * c
    j, off = pos >> 5, pos & 31
    pair = w[j] | (w[j + 1] << 32)
    return (pair >> off[:, None]) & ((1 << c) - 1)


def _lift(cops, rows: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """(B, 2*deg*24) affine rows -> (3*deg, 24, B) projective points;
    rows with y == 0 and lanes where `zero` is set become (0 : 1 : 0)."""
    deg, B = cops.deg, rows.shape[0]
    one = torch.from_numpy(L.int_to_words(cops.F.ctx.r)).to(rows.device)
    pts = torch.zeros((3 * deg, L.NWORDS, B), dtype=torch.int32,
                      device=rows.device)
    pts[:2 * deg] = rows.t().reshape(2 * deg, L.NWORDS, B)
    pts[2 * deg] = one[:, None]
    inf = zero | (rows[:, deg * L.NWORDS:] == 0).all(1)
    pts[:, :, inf] = identity_words(cops, 1, rows.device)
    return pts


def straus_window_sums(cops, keys, table_rows, c: int = STRAUS_C,
                       add=None):
    """Window sums of one table MSM: (3*deg, 24, num_windows(c)) int32,
    column w the sum over i of digit_w(s_i) * P_i.

    `add` is the group add (default group_kernels.ec_add, looked up at
    each call); straus_window_sums_plain passes its plain version."""
    add = add or group_kernels.ec_add
    deg = cops.deg
    nmul = (1 << c) - 1
    F3 = 3 * deg
    if (table_rows.dim() != 2 or table_rows.shape[1] != 2 * deg * L.NWORDS
            or table_rows.shape[0] % nmul or table_rows.shape[0] == 0):
        raise ValueError(f"table rows shape {tuple(table_rows.shape)}")
    n = table_rows.shape[0] // nmul
    if tuple(keys.shape) != (L.NWORDS, n):
        raise ValueError(f"keys shape {tuple(keys.shape)}, want (24, {n})")
    dev = table_rows.device
    dig = straus_digits(keys.to(dev), c)
    nwin = dig.shape[0]
    wb = window_block(deg, n, c)
    iota = torch.arange(n, device=dev)
    sums = []
    for w0 in range(0, nwin, wb):
        d = dig[w0:w0 + wb]
        k = d.shape[0]
        idx = ((d - 1).clamp(min=0) * n + iota).reshape(-1)
        pts = _lift(cops, table_rows[idx], d.reshape(-1) == 0)
        pts = pts.reshape(F3, L.NWORDS, k, n)
        while pts.shape[-1] > 1:
            h = pts.shape[-1] // 2
            s = add(cops, *(pts[..., a:a + h].reshape(F3, L.NWORDS, k * h)
                            .contiguous() for a in (0, h)))
            pts = torch.cat([s.reshape(F3, L.NWORDS, k, h),
                             pts[..., 2 * h:]], -1)
        sums.append(pts[..., 0])
    return torch.cat(sums, -1)


def straus_window_sums_plain(cops, keys, table_rows, c: int = STRAUS_C):
    """Plain version: the same tree on the plain group add."""
    return straus_window_sums(cops, keys, table_rows, c,
                              add=group_kernels.ec_add_plain)


def msm_straus(cops, host_group, scalars, table_rows, device="cuda"):
    """Table MSM from host inputs to a host point (the test and oracle
    entry, as msm_straus_device is in the JAX package): scalars are
    Python ints, table_rows word rows (numpy or tensor)."""
    keys = torch.from_numpy(L.ints_to_words(scalars)).to(device)
    ws = straus_window_sums(cops, keys, torch.as_tensor(table_rows)
                            .to(device))
    return finalize_msm(host_group, window_sums_to_host(cops, ws)[0],
                        STRAUS_C)
