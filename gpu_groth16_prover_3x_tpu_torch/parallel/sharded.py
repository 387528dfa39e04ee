"""Multi-device sharding on torch.distributed: the points-parallel MSM and
the four-step all-to-all NTT.

The PyTorch counterpart of gpu_groth16_prover_3x_tpu/parallel/sharded.py
(shard_map over a 1-D mesh there; one process a rank here, each holding
its shard as local tensors):

  * MSM, data parallelism over points: each rank runs the whole Pippenger
    pass (ops/msm.py) on its points; the (3*deg, 24, nwin*num) window
    sums, tens of KB, travel by one all_gather and are combined by a
    log-depth pairwise `ec_add` with the odd rank carried up.
  * NTT, the domain sharded: the four-step transform
        y[k2*n1 + k1] = sum_j2 w^(j2*k1) w_n2^(j2*k2)
                         * sum_j1 x[j1*n2 + j2] w_n1^(j1*k1)
    with its three transposes as `all_to_all_single` and the column and
    row transforms as batched local NTTs (ops/ntt.ntt on (24, B, n)).

A rank holds the flat indices [rank*n/D, (rank+1)*n/D) of an NTT vector
as (24, n/D) words.  `group` None means the default process group when
torch.distributed is initialised, else one process, where every exchange
is the identity.
"""

import torch
import torch.distributed as dist

from ..curves.constants import FieldParams, get_root_of_unity
from ..ops import limbs as L
from ..ops.ec import CurveOps
from ..ops.group_kernels import ec_add
from ..ops.mont_mul import mont_mul
from ..ops.msm import DEFAULT_CHUNK, msm_window_sums_streamed
from ..ops.ntt import ntt, power_table, scale
from ..utils import opcount


class Comm:
    """The collectives of one process group as this layer uses them.

    On the gloo backend a CUDA tensor goes through a pinned host buffer
    and back (an explicit branch on the backend); nccl takes it as it is.
    The bytes a rank sends to the others are counted as
    `all_to_all_bytes` / `all_gather_bytes` (utils/opcount.py)."""

    def __init__(self, group=None):
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        if group is None:
            self.size, self.rank, self.backend = 1, 0, None
        else:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = dist.get_backend(group)

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        if self.backend == "gloo" and x.is_cuda:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return buf.copy_(x)
        return x.contiguous()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x (D, ...): block j goes to rank j; returns (D, ...) whose
        block j came from rank j."""
        if self.group is None:
            return x
        src = self._host(x)
        got = torch.empty_like(src)
        dist.all_to_all_single(got, src, group=self.group)
        opcount.add("all_to_all_bytes",
                    x.nbytes // self.size * (self.size - 1))
        return got.to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x (...) -> (D, ...), stacked in rank order."""
        if self.group is None:
            return x[None]
        src = self._host(x)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        opcount.add("all_gather_bytes", x.nbytes * (self.size - 1))
        return torch.stack(parts).to(x.device)


# -- sharded MSM --------------------------------------------------------------

def _combine_window_sums(cops: CurveOps, stacked: torch.Tensor):
    """(D, 3*deg, 24, W) per-rank window sums -> (3*deg, 24, W): log-depth
    pairwise group adds batched over windows and fused MSMs, the odd rank
    carried up."""
    arr = stacked
    while arr.shape[0] > 1:
        half = arr.shape[0] // 2
        F3, nw, W = arr.shape[1:]

        def flat(a):
            return a.permute(1, 2, 0, 3).reshape(F3, nw, half * W) \
                .contiguous()
        s = ec_add(cops, flat(arr[:half]), flat(arr[half:2 * half]))
        s = s.reshape(F3, nw, half, W).permute(2, 0, 1, 3)
        arr = torch.cat([s, arr[2 * half:]]) if arr.shape[0] % 2 else s
    return arr[0]


def sharded_msm_window_sums(cops: CurveOps, keys_l, rows_l,
                            chunk_s: int = DEFAULT_CHUNK, c: int = 16,
                            seg_l=None, num_msms: int = 1,
                            signed: bool = False, group=None,
                            combine: bool = True, block_points=None):
    """Window sums of an MSM whose points are sharded over the ranks.

    keys_l (24, n_l) and rows_l (n_l, 2*deg*24): this rank's scalars and
    affine rows, n_l a multiple of chunk_s (ranks may hold different
    counts); rows_l on the device or in host memory, uploaded a block at
    a time (ops/msm.msm_window_sums_streamed); seg_l (n_l,) the MSM index per point, as in
    ops/msm.msm_window_sums.  Every rank returns the combined
    (3*deg, 24, nwin*num_msms) sums, or with combine=False the stacked
    per-rank sums (D, 3*deg, 24, nwin*num_msms).

    block_points streams in global blocks of that many points: global
    block b is every rank's b-th block of block_points / D points; blocks
    add by MSM linearity on each rank (ops/msm.msm_window_sums_streamed)
    and the ranks' sums are gathered once."""
    comm = Comm(group)
    blk = None
    if block_points is not None:
        blk = max(chunk_s, block_points // comm.size // chunk_s * chunk_s)
    ws = msm_window_sums_streamed(cops, keys_l, rows_l, chunk_s, c, seg_l,
                                  num_msms, blk, signed)
    stacked = comm.all_gather(ws)
    return _combine_window_sums(cops, stacked) if combine else stacked


# -- sharded NTT (four steps, all_to_all transposes) -----------------------------

def ntt_split(n: int):
    """The four-step factors (n1, n2) of an n-point NTT: n1 =
    2^floor(log2 n / 2), n2 = n / n1.  Any number of ranks that divides
    both runs it (a power of two up to n1)."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"NTT size {n} is not a power of two")
    half = (n.bit_length() - 1) // 2
    return 1 << half, n >> half


class ShardedNttPlan:
    """One rank's tables for a distributed n = n1 * n2 NTT over `ndev`
    ranks (n1 = 2^floor(log2 n / 2), n2 = n / n1, both divisible by
    ndev), built on `device` by Montgomery products (no O(n) host loop):

      tw1 / tw2   sub-transform twiddles of omega_n1 = omega^n2 and
                  omega_n2 = omega^n1, forward and inverse (replicated);
      tw_mat      this rank's rows j2 of W[j2, k1] = omega^(j2*k1);
      coset / coset_inv
                  this rank's slice of g^i / g^-i (the H pipeline,
                  ops/ntt.compute_h with sharded_ntt as its transform).

    `ctx` and `mul` make it a plan for ops/ntt.ntt."""

    def __init__(self, fp: FieldParams, n: int, ndev: int, rank: int,
                 device):
        self.n1, self.n2 = ntt_split(n)
        if self.n1 % ndev or self.n2 % ndev:
            raise ValueError(f"n1={self.n1}, n2={self.n2} must be divisible "
                             f"by the number of ranks ({ndev})")
        if not 0 <= rank < ndev:
            raise ValueError(f"rank {rank} of {ndev}")
        self.fp, self.n, self.ndev, self.rank = fp, n, ndev, rank
        self.device = torch.device(device)
        self.ctx = L.MontCtx(fp.p)
        self.mul = mont_mul
        p = fp.p
        omega = get_root_of_unity(fp, n)
        self.tw1, self.tw2, self.tw_mat = {}, {}, {}
        for inverse, om in ((False, omega), (True, pow(omega, -1, p))):
            self.tw1[inverse] = self._powers(pow(om, self.n2, p),
                                             max(self.n1 // 2, 1))
            self.tw2[inverse] = self._powers(pow(om, self.n1, p),
                                             max(self.n2 // 2, 1))
            self.tw_mat[inverse] = self._twiddle_rows(om)
        g = fp.multiplicative_generator
        self.coset = self._slice_powers(g)
        self.coset_inv = self._slice_powers(pow(g, -1, p))
        self.n_inv = self.ctx.mont(pow(n, -1, p))
        self.z_coset_inv = self.ctx.mont(pow(pow(g, n, p) - 1, -1, p))

    def _powers(self, base: int, count: int) -> torch.Tensor:
        return power_table(self.ctx, base, count, self.device, self.mul)

    def _slice_powers(self, base: int) -> torch.Tensor:
        """base^i for this rank's flat indices i: base^lo * base^j."""
        count = self.n // self.ndev
        lo = self.rank * count
        return scale(self, self._powers(base, count),
                     self.ctx.mont(pow(base, lo, self.fp.p)))

    def _twiddle_rows(self, omega: int) -> torch.Tensor:
        """(24, n2/D, n1): rows j2 = r0 + j of W[j2, k1] = omega^(j2*k1).
        Row r0 is (omega^r0)^k1; rows [k, 2k) are rows [0, k) times the
        vector omega^(k*k1), squared from omega^k1 once a doubling."""
        rows, n1 = self.n2 // self.ndev, self.n1
        r0 = self.rank * rows
        out = torch.empty((L.NWORDS, rows, n1), dtype=torch.int32,
                          device=self.device)
        out[:, 0] = self._powers(pow(omega, r0, self.fp.p), n1)
        step = self._powers(omega, n1)
        k = 1
        while k < rows:
            m = min(k, rows - k)
            out[:, k:k + m] = self.mul(
                self.ctx, out[:, :m].contiguous(),
                step[:, None, :].expand(L.NWORDS, m, n1).contiguous())
            k += m
            if k < rows:
                step = self.mul(self.ctx, step, step)
        return out


def _dist_transpose(comm: Comm, v: torch.Tensor) -> torch.Tensor:
    """This rank's rows (24, a/D, b) of an (a, b) matrix -> its rows
    (24, b/D, a) of the transpose: one all_to_all of D column blocks
    (made dim 0 and contiguous for the exchange) and a local transpose."""
    D = comm.size
    a_l, b = v.shape[1:]
    blocks = v.reshape(L.NWORDS, a_l, D, b // D).permute(2, 0, 1, 3)
    got = comm.all_to_all(blocks.contiguous())     # block s: rank s's rows
    got = got.permute(1, 0, 2, 3).reshape(L.NWORDS, D * a_l, b // D)
    return got.transpose(1, 2).contiguous()


def sharded_ntt(splan: ShardedNttPlan, x_local: torch.Tensor,
                inverse: bool = False, group=None) -> torch.Tensor:
    """Distributed DFT of a vector whose rank shards are (24, n/D) words;
    returns this rank's shard of the result, equal word for word to the
    same slice of ops/ntt.ntt on the whole vector.  inverse=True is the
    inverse transform, 1/n scale included."""
    comm = Comm(group)
    if (comm.size, comm.rank) != (splan.ndev, splan.rank):
        raise ValueError(f"plan for rank {splan.rank} of {splan.ndev}, "
                         f"group gives rank {comm.rank} of {comm.size}")
    n1, n2, D = splan.n1, splan.n2, splan.ndev
    if tuple(x_local.shape) != (L.NWORDS, splan.n // D):
        raise ValueError(f"shard shape {tuple(x_local.shape)}, want "
                         f"(24, {splan.n // D})")
    v = _dist_transpose(comm, x_local.reshape(L.NWORDS, n1 // D, n2))
    v = ntt(splan, v, splan.tw1[inverse])           # over j1, rows j2
    v = splan.mul(splan.ctx, v, splan.tw_mat[inverse])
    v = _dist_transpose(comm, v)                    # rows k1
    v = ntt(splan, v, splan.tw2[inverse])           # over j2
    v = _dist_transpose(comm, v).reshape(L.NWORDS, -1)   # rows k2: flat
    return scale(splan, v, splan.n_inv) if inverse else v

