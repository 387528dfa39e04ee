"""Pippenger multi-scalar multiplication, and kernel 3: the bucket scan.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/ops/msm.py
(`_window_kernel_parts`, `msm_window_sums`, `msm_window_sums_streamed`
with host-resident rows uploaded on a copy stream, `msm_device`).
Per block of windows:

  1. digits: c-bit windows of the 768-bit scalars (c in 4, 8, 16),
     optionally recoded to signed digits by a borrow ripple;
  2. argsort the points by (window, msm, digit) key, so each bucket is a
     contiguous run;
  3. the bucket scan (csrc/msm_scan.cu): the sorted order is cut into
     chunks of S points, one group of 4 or 8 warp lanes per chunk walks
     its S steps, accumulating same-key points with an XYZZ mixed add
     and emitting every finished run total as a projective point;
  4. runs that cross chunk borders are stitched by a Hillis-Steele carry
     chain over chunk tails (group add kernel), then boundary totals;
  5. run totals scatter into dense bucket tables (keys are unique);
  6. the halving reduction sum_b b * bucket_b over all windows at once
     (group add / dbl kernels):  W <- W_A + W_B + S_B,  S <- dbl(S_A + S_B).

The window sums are recombined on the host by exact Horner doubling, as
the reference finishes on the CPU (cuda_prover_piecewise.cu:188-200):
`finalize_windows_native` hands the words to the native host library
(utils/native.horner_proj); `finalize_msm` is the plain Python version
and the fallback when the library is absent.

Scalars are (24, n) int32 standard-domain words; points are the file's
affine rows (n, 2*deg*24) int32 (x coefficients, then y; y == 0 encodes
the point at infinity).  Window sums are (3*deg, 24, nwin*num_msms)
int32 projective points, column w*num_msms + msm.
"""

import ctypes

import numpy as np
import torch

from ..host import field as HF
from ..utils import native, opcount
from ..utils.profiling import count, span
from . import build
from . import limbs as L
from .ec import CurveOps, from_limb_point, to_limb_point
from .group_kernels import ec_add, ec_dbl

DEFAULT_CHUNK = 128     # S: sequential steps per scan chunk
SCAN_LANES = 1 << 16    # aim for at least this many scan chunks a launch
SCAN_POINTS = 1 << 23   # cap on points (x windows) per scan launch
REDUCE_LANES = 1 << 23  # cap on bucket lanes per reduction pass

MSM_SCAN = build.Kernel("msm_scan")
# lanes of a scan chunk in each group configuration (csrc/field_coop.cuh
# G16_T): a warp walks 32 // lanes chunks together
CHUNK_LANES = {0: 4, 1: 8, 2: 4, 3: 8}


# -- identity / layout helpers -----------------------------------------------------

def identity_words(cops: CurveOps, n: int, device) -> torch.Tensor:
    """(0 : 1 : 0) as a (3*deg, 24, n) word tensor."""
    one = torch.from_numpy(L.int_to_words(cops.F.ctx.r)).to(device)
    out = torch.zeros((3 * cops.deg, L.NWORDS, n), dtype=torch.int32,
                      device=device)
    out[cops.deg] = one[:, None]
    return out


# -- kernel 3: the bucket scan -----------------------------------------------------

_PLAIN_TALLY = {}   # device -> the plain version's (doubling, conversion)
_LAUNCHED = set()   # devices on which the kernel ran
_FOLDED = {}        # device -> the part of scan_tally already in the record


def _device_key(device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def scan_tally(device) -> tuple:
    """(doubling, conversion): the warp-steps of every bucket scan on
    `device` so far in which some chunk of the warp doubled its row (the
    accumulator equal to the row it adds) and in which some chunk
    converted a run total (its run ending), the kernel's (a module
    variable of each configuration, csrc/msm_scan.cu) and the plain
    version's together.  Reads the device: the host waits."""
    key = _device_key(device)
    dbl, conv = _PLAIN_TALLY.get(key, (0, 0))
    if key in _LAUNCHED:
        lib = build.library()
        buf = (ctypes.c_ulonglong * 2)()
        with torch.cuda.device(torch.device(key)):
            for k in build.CFGS:
                build.check(getattr(lib, f"g16_msm_scan_tally_{k}")(
                    ctypes.addressof(buf)))
                dbl, conv = dbl + buf[0], conv + buf[1]
    return dbl, conv


def fold_scan_tally(device) -> None:
    """Add the scans' tallies since the last fold to the record as
    `#msm.scan_dbl` and `#msm.scan_convert` (utils/profiling.count).
    finalize_windows calls it after its readback, where the host has
    already waited for the card."""
    key = _device_key(device)
    if key not in _LAUNCHED and key not in _PLAIN_TALLY:
        return
    now = scan_tally(key)
    was = _FOLDED.get(key, (0, 0))
    _FOLDED[key] = now
    count("msm.scan_dbl", now[0] - was[0])
    count("msm.scan_convert", now[1] - was[1])


def msm_scan_plain(cops: CurveOps, rows, idx, keys, signs=None):
    """Plain version of the scan kernel: a Python loop of S steps.

    rows (n, 2*deg*24) int32; idx, keys (S, B) int32 (step-major);
    signs (S, B) bool or None.  Returns (em (3*deg, 24, S-1, B),
    em_valid (S-1, B) bool, tail, first (3*deg, 24, B), haschg (B,) bool).
    Where em_valid[s-1, b] is set, em[..., s-1, b] is the run total that
    ends before step s; elsewhere em is not defined (the kernel leaves it
    unwritten, this version zero).  first is the total of the chunk's
    first run where the chunk has a key change (else the identity), tail
    the total of its last run.

    The run accumulator is in XYZZ coordinates (CurveOps.xyzz_*): a step
    adds the next affine row with madd-2008-s, and takes the doubling of
    the row where the accumulator equals it; the identity plus a row is
    the row.  Points leave as projective (X : Y : Z) words (xyzz_to_proj)
    where a run ends and at the tail.  Adds the warp-steps that doubled
    and that converted, counted as the kernel counts them, to the scan
    tally (scan_tally)."""
    S, B = idx.shape
    deg, F = cops.deg, cops.F
    dev = rows.device
    ident = cops.xyzz_identity((B,), dev)

    def lift(s):
        r = rows[idx[s].long()]                           # (B, 2*deg*24)
        xy = to_limb_point(r.t().reshape(2 * deg, L.NWORDS, B), deg)
        x, y = xy[:, 0], xy[:, 1]
        inf = F.is_zero(y)                               # mask taken first
        if signs is not None:
            y = torch.where(signs[s], F.neg(y), y)
        lifted = torch.where(inf, ident, cops.xyzz_lift(x, y))
        return lifted, x, y, inf

    groups = 32 // CHUNK_LANES[cops.cfg]         # chunks a warp walks
    pad = -B % groups

    def warp_steps(mask) -> int:
        """Warps in which some chunk has `mask` set."""
        m = torch.cat([mask, mask.new_zeros(pad)])
        return int(m.reshape(-1, groups).any(1).sum())

    acc = lift(0)[0]
    first = identity_words(cops, B, dev)
    prevk = keys[0]
    chg = torch.zeros(B, dtype=torch.bool, device=dev)
    em = torch.zeros((3 * deg, L.NWORDS, S - 1, B), dtype=torch.int32,
                     device=dev)
    em_valid = torch.empty((S - 1, B), dtype=torch.bool, device=dev)
    n_dbl = n_conv = 0
    for s in range(1, S):
        same = keys[s] == prevk
        end = ~same
        em_valid[s - 1] = end & chg
        if bool(end.any()):
            n_conv += warp_steps(end)
            pts = from_limb_point(cops.xyzz_to_proj(acc[..., end]))
            done = chg[end]
            em[:, :, s - 1, end & chg] = pts[..., done]
            first[:, :, end & ~chg] = pts[..., ~done]
        lifted, x, y, inf = lift(s)
        nxt, dbl = cops.xyzz_add_row(acc, x, y, inf)
        n_dbl += warp_steps(dbl & same)
        acc = torch.where(same, nxt, lifted)         # a new key restarts
        chg = chg | end
        prevk = keys[s]
    key = _device_key(dev)
    was = _PLAIN_TALLY.get(key, (0, 0))
    _PLAIN_TALLY[key] = (was[0] + n_dbl, was[1] + n_conv)
    return (em, em_valid, from_limb_point(cops.xyzz_to_proj(acc)), first,
            chg)


def msm_scan(cops: CurveOps, rows, idx, keys, signs=None):
    """The bucket scan (see msm_scan_plain for the contract).  Counts
    S * B `msm_scan_step` point-steps on either route (utils/opcount), and
    adds the warp-steps that doubled and that converted to the device's
    scan tally (scan_tally)."""
    S, B = idx.shape
    dev = rows.device
    if rows.dim() != 2 or rows.shape[1] != 2 * cops.deg * L.NWORDS:
        raise ValueError(f"rows shape {tuple(rows.shape)}")
    if tuple(keys.shape) != (S, B) or (signs is not None
                                       and tuple(signs.shape) != (S, B)):
        raise ValueError("idx, keys and signs must share one (S, B) shape")
    opcount.add("msm_scan_step", S * B)
    if dev.type == "cpu":
        return msm_scan_plain(cops, rows, idx, keys, signs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    build.require(rows, dtype=torch.int32, name="rows")
    build.require(idx, dtype=torch.int32, device=dev, name="idx")
    build.require(keys, dtype=torch.int32, device=dev, name="keys")
    s8 = None
    if signs is not None:
        s8 = signs.to(torch.uint8).contiguous()
        build.require(s8, dtype=torch.uint8, device=dev, name="signs")
    F3 = 3 * cops.deg
    em = torch.empty((F3, L.NWORDS, S - 1, B), dtype=torch.int32, device=dev)
    em_valid = torch.empty((S - 1, B), dtype=torch.uint8, device=dev)
    tail = torch.empty((F3, L.NWORDS, B), dtype=torch.int32, device=dev)
    first = torch.empty_like(tail)
    haschg = torch.empty(B, dtype=torch.uint8, device=dev)
    launch = getattr(build.library(), f"g16_msm_scan_{cops.cfg}")
    build.check(launch(
        rows.data_ptr(), idx.data_ptr(), keys.data_ptr(),
        None if s8 is None else s8.data_ptr(), S, B, em.data_ptr(),
        em_valid.data_ptr(), tail.data_ptr(), first.data_ptr(),
        haschg.data_ptr(), build.stream_ptr(rows)))
    MSM_SCAN.launches += 1
    _LAUNCHED.add(_device_key(dev))
    return em, em_valid.bool(), tail, first, haschg.bool()


# -- digits ----------------------------------------------------------------------------

def window_digits(keys: torch.Tensor, c: int) -> torch.Tensor:
    """(24, n) scalar words -> (768 // c, n) int64 unsigned c-bit digits,
    least significant window first."""
    if c not in (4, 8, 16):
        raise ValueError(f"window bits must be 4, 8 or 16, not {c}")
    w = keys.to(torch.int64) & 0xFFFFFFFF
    per = 32 // c
    d = torch.stack([(w >> (c * k)) & ((1 << c) - 1) for k in range(per)], 1)
    return d.reshape(L.NWORDS * per, -1)


def signed_digits(dig: torch.Tensor, c: int):
    """Borrow ripple: a digit (plus the incoming carry) >= 2^(c-1) becomes
    d - 2^c with a carry into the next window.  Returns (magnitudes in
    0 .. 2^(c-1), negative flags).  The top window never overflows:
    scalars are < 2^753 while the windows span 768 bits."""
    half, full = 1 << (c - 1), 1 << c
    out = torch.empty_like(dig)
    carry = torch.zeros_like(dig[0])
    for w in range(dig.shape[0]):
        d2 = dig[w] + carry
        neg = d2 >= half
        out[w] = torch.where(neg, d2 - full, d2)
        carry = neg.to(dig.dtype)
    return out.abs(), out < 0


# -- one block of windows: sort, scan, stitch, scatter ----------------------------------

def _shift(a, fill, s: int, wb: int, C: int):
    """Shift (..., wb*C) by s chunks toward higher chunk index within each
    window; `fill` (broadcastable to (..., wb, s)) enters at the start."""
    a4 = a.reshape(a.shape[:-1] + (wb, C))
    f = fill.expand(a.shape[:-1] + (wb, s))
    return torch.cat([f, a4[..., :C - s]], -1).reshape(a.shape)


def _group_msm(cops: CurveOps, keys_grp, signs_grp, rows, S: int, NB: int,
               NT: int, signed: bool):
    """(wb, n) sort keys of one window block -> (3*deg*24, wb*NT) buckets
    (NT = num_msms * NB bucket rows per window)."""
    wb, n = keys_grp.shape
    dummy = wb * NT
    C = n // S
    B = wb * C
    dev = rows.device
    F3 = 3 * cops.deg

    with span("msm.sort"):
        order = torch.argsort(keys_grp, dim=-1, stable=True)
        ks = torch.gather(keys_grp, 1, order).reshape(B, S)
        ks_seq = ks.t().contiguous().to(torch.int32)             # (S, B)
        idx_seq = order.reshape(B, S).t().contiguous().to(torch.int32)
        sg_seq = None
        if signs_grp is not None:
            sg_seq = torch.gather(signs_grp, 1, order).reshape(B, S).t() \
                .contiguous()
    with span("msm.scan"):
        em, em_valid, tail, first, haschg = msm_scan(cops, rows, idx_seq,
                                                     ks_seq, sg_seq)
    del order, idx_seq, sg_seq
    head_key, tail_key = ks_seq[0], ks_seq[S - 1]
    uniform = ~haschg
    ident = identity_words(cops, 1, dev)[..., None]     # (F3, 24, 1, 1)

    # cross-chunk carry chain (Hillis-Steele, early exit)
    with span("msm.carry"):
        link = torch.zeros((wb, C), dtype=torch.bool, device=dev)
        link[:, 1:] = tail_key.reshape(wb, C)[:, :-1] == \
            head_key.reshape(wb, C)[:, 1:]
        link = link.reshape(B)
        no = torch.zeros((1, 1), dtype=torch.bool, device=dev)
        val = torch.where(link, _shift(tail, ident, 1, wb, C),
                          ident[..., 0])
        prop = link & _shift(uniform, no, 1, wb, C)
        s = 1
        while s < C and _any_on_host(prop):
            comb = ec_add(cops, val, _shift(val, ident, s, wb, C))
            val = torch.where(prop, comb, val)
            prop = prop & _shift(prop, no, s, wb, C)
            s *= 2

    # boundary totals
    first_total = ec_add(cops, first, val)
    tail_total = torch.where(uniform, ec_add(cops, tail, val), tail)
    link_next = torch.zeros((wb, C), dtype=torch.bool, device=dev)
    link_next[:, :-1] = link.reshape(wb, C)[:, 1:]
    link_next = link_next.reshape(B)

    # scatter run totals into the dense bucket tables
    if signed:
        def to_slot(k, valid):
            blk = k // (NB + 1)
            r = k - blk * (NB + 1)
            return torch.where(valid & (r > 0), blk * NB + r - 1,
                               torch.full_like(k, dummy))
    else:
        def to_slot(k, valid):
            return torch.where(valid, k, torch.full_like(k, dummy))

    table = identity_words(cops, dummy, dev).reshape(F3 * L.NWORDS, -1)
    for keys_, valid, vals in (
            (ks_seq[:-1].reshape(-1).long(), em_valid.reshape(-1),
             em.reshape(F3 * L.NWORDS, -1)),
            (head_key.long(), haschg, first_total.reshape(F3 * L.NWORDS, B)),
            (tail_key.long(), ~link_next,
             tail_total.reshape(F3 * L.NWORDS, B))):
        slot = to_slot(keys_, valid)
        keep = slot != dummy
        table.index_copy_(1, slot[keep], vals[:, keep])
    return table


def _any_on_host(t: torch.Tensor) -> bool:
    """bool(t.any()): the host waits for the device to drain; counted as
    `#msm.host_syncs`."""
    count("msm.host_syncs")
    return bool(t.any())


# -- the halving reduction -----------------------------------------------------------

def _reduce(cops: CurveOps, bt, NB: int, signed: bool):
    """(3*deg, 24, G*NB) buckets -> (3*deg, 24, G) sums sum_b w(b)*bucket_b
    per group of NB, with w(b) = b (unsigned) or b + 1 (signed: starting W
    at the buckets adds sum_b bucket_b once).  Adjacent buckets pair up
    (even = lower weight), so pairs never straddle a group."""
    with span("msm.reduce"):
        Sp = bt
        W = bt if signed else identity_words(cops, bt.shape[-1], bt.device)
        m = NB
        while m > 1:
            Sa, Sb = Sp[..., 0::2].contiguous(), Sp[..., 1::2].contiguous()
            Wa, Wb = W[..., 0::2].contiguous(), W[..., 1::2].contiguous()
            W = ec_add(cops, ec_add(cops, Wa, Wb), Sb)
            m //= 2
            if m > 1:
                Sp = ec_dbl(cops, ec_add(cops, Sa, Sb))
    return W


# -- window sums ---------------------------------------------------------------------

def _fit_block(nwin: int, target: int) -> int:
    wb = min(nwin, max(1, target))
    while nwin % wb:
        wb -= 1
    return wb


def msm_window_sums(cops: CurveOps, keys, rows, chunk_s: int = DEFAULT_CHUNK,
                    c: int = 16, seg_ids=None, num_msms: int = 1,
                    signed: bool = False):
    """Window sums of `num_msms` MSMs over one group, fused into one pass.

    keys (24, n) int32 scalar words; rows (n, 2*deg*24) int32; n a
    multiple of chunk_s.  seg_ids (n,) int: MSM index per point (the index
    rides the sort key, so runs never merge across MSMs).  Returns
    (3*deg, 24, (768 // c) * num_msms) int32."""
    n = rows.shape[0]
    if n % chunk_s:
        raise ValueError(f"{n} points is not a multiple of chunk {chunk_s}")
    if keys.shape != (L.NWORDS, n):
        raise ValueError(f"keys shape {tuple(keys.shape)}, want (24, {n})")
    dev = rows.device
    NB = (1 << (c - 1)) if signed else (1 << c)
    key_span = NB + 1 if signed else NB             # sort-key span per msm
    with span("msm.sort"):
        dig = window_digits(keys, c)
        signs = None
        if signed:
            dig, signs = signed_digits(dig, c)
        if seg_ids is not None:
            dig = dig + seg_ids.to(dev, torch.int64)[None, :] * key_span
    nwin = dig.shape[0]
    C = n // chunk_s
    wb = _fit_block(nwin, min(max(1, SCAN_LANES // C),
                              max(1, SCAN_POINTS // n)))
    NT = num_msms * NB
    offs = torch.arange(wb, device=dev, dtype=torch.int64)[:, None] \
        * (num_msms * key_span)
    tables = []
    for w0 in range(0, nwin, wb):
        tables.append(_group_msm(
            cops, dig[w0:w0 + wb] + offs,
            None if signs is None else signs[w0:w0 + wb], rows, chunk_s,
            NB, NT, signed))
    del dig, signs
    bt = torch.cat(tables, 1).reshape(3 * cops.deg, L.NWORDS, -1)
    del tables
    gpr = max(1, REDUCE_LANES // NB)               # groups per pass
    G = nwin * num_msms
    outs = [_reduce(cops, bt[..., g0 * NB:min(G, g0 + gpr) * NB]
                    .contiguous(), NB, signed)
            for g0 in range(0, G, gpr)]
    return torch.cat(outs, -1)


def combine_window_sums(cops: CurveOps, ws_a, ws_b):
    """Pointwise add of two window-sum stacks: MSM linearity over point
    blocks (a streamed MSM adds its blocks' window sums)."""
    return ec_add(cops, ws_a, ws_b)


class HostRowBlocks:
    """Host-resident point rows uploaded to a card one block at a time on
    a copy stream of their own (the JAX package's host-resident staging,
    ops/msm.py `stage`).

    issue(i) copies block i's slice of the host rows into one of two
    pinned staging buffers of one block each (the whole array is never
    pinned: at the sizes that need this path it is tens of GB), starts
    its upload on the copy stream and returns the device block with the
    event that the compute stream waits for before reading it.  The two
    races, either of which would give a wrong proof and no error:

      1. a staging buffer is rewritten only after the upload that reads
         it has finished: the host waits on that upload's event;
      2. a device block is allocated on the copy stream and read on the
         compute stream: record_stream keeps the caching allocator from
         handing its memory to another copy-stream tensor before the
         compute stream's work on it is done.
    """

    def __init__(self, rows, B: int, device):
        self.rows = torch.as_tensor(rows)
        if self.rows.dtype != torch.int32 or self.rows.dim() != 2:
            raise ValueError(f"host rows must be (n, k) int32, not "
                             f"{self.rows.dtype} {tuple(self.rows.shape)}")
        self.B, self.device = B, device
        self.copy = torch.cuda.Stream(device)
        self.staging = []
        self.uploaded = []      # per staging buffer: its last upload

    def issue(self, i: int):
        with span("msm.upload"):
            k = i % 2
            if k == len(self.staging):
                self.staging.append(torch.empty((self.B, self.rows.shape[1]),
                                                dtype=torch.int32,
                                                pin_memory=True))
                self.uploaded.append(None)
            buf = self.staging[k]
            if self.uploaded[k] is not None:
                count("msm.host_syncs")
                self.uploaded[k].synchronize()                    # race 1
            part = self.rows[i * self.B:(i + 1) * self.B]
            buf[:part.shape[0]].copy_(part)
            buf[part.shape[0]:].zero_()         # y == 0 rows: exact no-ops
            with torch.cuda.stream(self.copy):
                blk = upload_block(buf, self.device)
                done = torch.cuda.Event()
                done.record()
            blk.record_stream(torch.cuda.current_stream(self.device))  # race 2
            self.uploaded[k] = done
            return blk, done


def upload_block(pinned: torch.Tensor, device) -> torch.Tensor:
    """A new device copy of a pinned host block, issued on the current
    stream (HostRowBlocks runs it on its copy stream)."""
    out = torch.empty(pinned.shape, dtype=pinned.dtype, device=device)
    out.copy_(pinned, non_blocking=True)
    return out


def block_grid(n: int, chunk_s: int, block_points):
    """(blocks, points a block) of msm_window_sums_streamed over n points:
    ceil(n / block_points) balanced blocks (one when block_points is
    None), each a multiple of chunk_s.  When chunk_s divides block_points,
    the grid of its own padded width is the same grid, so rows and keys
    padded to it once are never padded again."""
    nblk = 1 if block_points is None else -(-n // max(chunk_s,
                                                       block_points))
    per = -(-n // nblk)
    B = -(-per // chunk_s) * chunk_s
    return -(-n // B), B        # rounding B up can leave a block empty


def grid_points(n: int, chunk_s: int, block_points) -> int:
    """n rounded up to msm_window_sums_streamed's block grid."""
    nblk, B = block_grid(n, chunk_s, block_points)
    return nblk * B


def msm_window_sums_streamed(cops: CurveOps, keys, rows,
                             chunk_s: int = DEFAULT_CHUNK, c: int = 16,
                             seg_ids=None, num_msms: int = 1,
                             block_points: int = None, signed: bool = False):
    """msm_window_sums over bounded blocks of points, window sums combined.

    The blocks are block_grid's; the tail is padded with y == 0 rows and
    zero keys, exact no-ops (a copy of keys and device rows: callers that
    give them at grid_points' width skip it).

    keys and seg_ids lie on the device.  rows lie on the device too, or
    on the host (a numpy array or a CPU tensor).  Host rows on a CUDA
    device go up one block at a time (HostRowBlocks; with block_points
    None, as one block): block i + 1's upload is issued once block i's
    scans and reduction are queued, so the copy runs while the card
    reduces block i, and it waits for nothing but the staging buffer it
    reuses.  (The scan's carry chain reads `prop.any()` on the host once
    per step; the copy is issued after those reads.)  There is no other
    way for host rows onto a card: a failed copy or launch raises.  On
    the CPU the same block loop slices the host rows in place.

    Each block's msm_window_sums (a single pass's too) is the span
    "msm.block", counted under "#msm.blocks"; each combine of two
    blocks' window sums is the span "msm.combine" (utils/profiling.py)."""
    n = rows.shape[0]
    dev = keys.device
    host = not torch.is_tensor(rows) or rows.device.type == "cpu"
    if host and dev.type == "cpu":
        rows, host = torch.as_tensor(rows), False
    elif not host and rows.device != dev:
        raise ValueError(f"rows on {rows.device}, keys on {dev}")
    if not host and (block_points is None or block_points >= n):
        return _block_window_sums(cops, keys, rows, chunk_s, c, seg_ids,
                                  num_msms, signed)
    nblk, B = block_grid(n, chunk_s, block_points)
    n_full = nblk * B
    if n_full > n:
        keys = torch.cat([keys, keys.new_zeros((L.NWORDS, n_full - n))], 1)
        if seg_ids is not None:
            seg_ids = torch.cat([seg_ids, seg_ids.new_zeros(n_full - n)])
        if not host:
            rows = torch.cat([rows, rows.new_zeros((n_full - n,
                                                    rows.shape[1]))])
    if host:
        blocks = HostRowBlocks(rows, B, dev)
        pending = blocks.issue(0)
    acc = None
    for i, lo in enumerate(range(0, n_full, B)):
        if host:
            blk, done = pending
            pending = None
            torch.cuda.current_stream(dev).wait_event(done)
        else:
            blk = rows[lo:lo + B]
        ws = _block_window_sums(
            cops, keys[:, lo:lo + B].contiguous(), blk, chunk_s, c,
            None if seg_ids is None else seg_ids[lo:lo + B], num_msms,
            signed)
        del blk
        if host and i + 1 < nblk:
            pending = blocks.issue(i + 1)
        if acc is None:
            acc = ws
        else:
            with span("msm.combine"):
                acc = combine_window_sums(cops, acc, ws)
    return acc


def _block_window_sums(cops: CurveOps, keys, rows, chunk_s, c, seg_ids,
                       num_msms, signed):
    """msm_window_sums of one block of msm_window_sums_streamed (the one
    block of a single pass too): the span "msm.block", counted under
    "#msm.blocks"."""
    count("msm.blocks")
    with span("msm.block"):
        return msm_window_sums(cops, keys, rows, chunk_s, c, seg_ids,
                               num_msms, signed)


def msm_device(cops: CurveOps, host_group, scalars, points,
               chunk_s: int = DEFAULT_CHUNK, c: int = 16,
               signed: bool = False, block_points: int = None,
               device="cuda"):
    """End-to-end MSM from host scalars (standard domain) and host affine
    points ((x, y), coefficient tuples over an extension, the zero as
    (0, 0)) to a host point: the points stay on the host as the file's
    Montgomery word rows and go through msm_window_sums_streamed (in
    blocks of block_points; on a card through its copy stream), then
    finalize_msm.  The counterpart of the JAX package's
    ops/msm.msm_device (a test and oracle helper)."""
    n, p, r = len(scalars), cops.p, 1 << L.R_BITS
    n_pad = max(chunk_s, -(-n // chunk_s) * chunk_s)
    coords = [v * r % p for pt in points for v in (
        (pt[0], pt[1]) if cops.deg == 1 else (*pt[0], *pt[1]))]
    rows = np.zeros((n_pad, 2 * cops.deg * L.NWORDS), np.int32)
    rows[:n] = L.ints_to_words(coords).T.reshape(n, -1)
    keys = torch.from_numpy(L.ints_to_words(
        list(scalars) + [0] * (n_pad - n))).to(device)
    ws = msm_window_sums_streamed(cops, keys, rows, chunk_s, c, None, 1,
                                  block_points, signed)
    pts, = window_sums_to_host(cops, ws)
    return finalize_msm(host_group, pts, c)


# -- host finalization ----------------------------------------------------------------

def window_sums_to_host(cops: CurveOps, ws, num_msms: int = 1):
    """(3*deg, 24, nwin*num_msms) window sums -> per-MSM lists of host
    projective points (standard domain): out[msm][window]."""
    deg, p = cops.deg, cops.p
    rinv = pow(1 << L.R_BITS, -1, p)
    coords = [[v * rinv % p for v in L.words_to_ints(ws[k].cpu().numpy())]
              for k in range(3 * deg)]
    nwin = ws.shape[-1] // num_msms
    out = []
    for msm_i in range(num_msms):
        pts = []
        for w in range(nwin):
            col = w * num_msms + msm_i
            xyz = [tuple(coords[i * deg + j][col] for j in range(deg))
                   for i in range(3)]
            pts.append(tuple(v[0] for v in xyz) if deg == 1 else tuple(xyz))
        out.append(pts)
    return out


def proj_to_host(host_group, pt):
    """Homogeneous projective (X : Y : Z) -> host (Jacobian) element."""
    x, y, z = pt
    p = host_group.p
    if host_group.deg == 1:
        if z % p == 0:
            return host_group.zero
        zi = pow(z, -1, p)
        return host_group.from_affine((x * zi % p, y * zi % p))
    if all(c % p == 0 for c in z):
        return host_group.zero
    zi = HF.e_inv(z, p, host_group.alpha)
    return host_group.from_affine((HF.e_mul(x, zi, p, host_group.alpha),
                                   HF.e_mul(y, zi, p, host_group.alpha)))


def finalize_msm(host_group, window_pts, cbits: int):
    """Horner recombination sum_w 2^(cbits*w) * W_w, exact on the host."""
    acc = host_group.zero
    for w in range(len(window_pts) - 1, -1, -1):
        for _ in range(cbits):
            acc = host_group.dbl(acc)
        acc = host_group.add(acc, proj_to_host(host_group, window_pts[w]))
    return acc


def finalize_windows_native(cops: CurveOps, host_group, ws, cbits: int,
                            num_msms: int = 1):
    """finalize_msm of every MSM of a window-sum stack in the native host
    library: a list of host Jacobian points, one per MSM, or None when
    the library is absent (callers fall back to window_sums_to_host +
    finalize_msm).  The counterpart of the JAX package's
    ops/msm.finalize_windows_native.

    The words go straight to native.horner_proj: a window's 3*deg
    coordinates of 24 little-endian 32-bit words are its 3*deg*12
    little-endian 64-bit limbs, canonical Montgomery at R = 2^768 with the
    identity's Z = 0, which is the library's row layout."""
    if not native.available():
        return None
    deg, p = cops.deg, cops.p
    nwin = ws.shape[-1] // num_msms
    with span("epilogue.readback"):
        a = ws.cpu().numpy().reshape(3 * deg, L.NWORDS, nwin, num_msms)
        rows = np.ascontiguousarray(a.transpose(3, 2, 0, 1)).view(
            np.uint64)
    rows = rows.reshape(num_msms, nwin, 3 * deg * L.NWORDS // 2)
    with span("epilogue.horner"):
        return [native.horner_proj(p, deg, host_group.alpha, host_group.a,
                                   rows[i], cbits) for i in range(num_msms)]


def finalize_windows(cops: CurveOps, host_group, ws, cbits: int,
                     num_msms: int = 1):
    """Per-MSM host points of a window-sum stack: the native epilogue,
    else the plain one.  The readback has drained the card, so the scan
    tally is folded into the record here (fold_scan_tally)."""
    out = finalize_windows_native(cops, host_group, ws, cbits, num_msms)
    if out is None:
        with span("epilogue.readback"):
            per_msm = window_sums_to_host(cops, ws, num_msms)
        with span("epilogue.horner"):
            out = [finalize_msm(host_group, pts, cbits) for pts in per_msm]
    fold_scan_tally(ws.device)
    return out
