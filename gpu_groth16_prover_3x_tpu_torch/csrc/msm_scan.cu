// Pippenger bucket scan: all S steps of a chunk in one group of T lanes.
//
// Replaces the TPU kernel of gpu_groth16_prover_3x_tpu/ops/pallas_group.py
// `_fuse_build` (the pl.pallas_call at :490), whose only caller runs ONE
// scan step (ops/msm.py step_core, :413-441) per launch under a lax.scan
// of S - 1 launches (msm.py:466).  Here one launch covers a window block:
// group b (T neighbouring lanes of a warp) owns chunk b (S consecutive
// points of one window's digit-sorted order) and loops over its S steps
// with the run accumulator spread over its lanes' registers
// (csrc/field_coop.cuh).  Per step it lifts the next sorted affine point
// (y -> p - y for a negative digit, the infinity mask y == 0 taken first),
// adds it to the accumulator when the key repeats or restarts the run when
// it changes, and writes the same emissions, first partial, tail and
// has-changed flag that the stitch and scatter stages consume.
//
// Bound on the H100: 32-bit integer multiply-adds.  A G1 mixed add is 13
// Fq products (about 30k multiply-adds, 1.8 ns at 16.75e12/s) per step
// against 192 B of point row read and 288 B of emission written (0.14 ns
// at 3.35 TB/s): operations bound it, about 12x over the bytes.  One
// thread per chunk kept accumulator, operand and temporaries (2 to 8 KB)
// in local memory at 8 warps an SM, 5 to 13 times over the bound.  Spread
// over T lanes (4 for G1, 8 for the towers) the state is registers only
// and 12 warps are resident (8 for Fq3).  The step is branch-free: the
// mixed add always runs and selects pick the restart and the infinity
// row, so the lanes of a warp stay in step (every shuffle names the whole
// warp); a run changes on a few percent of the main path's steps.  Only
// the stores are conditional.
//
// Memory access: the T lanes of a group read the 24 consecutive words of
// each coefficient of the chunk's next row together (one to two 128-byte
// lines), through the sorted index straight from the (n, 2*D*24)
// file-layout rows (no gathered copy), and the row of step s + 1 is
// fetched before the mixed add of step s so the random access hides under
// it.  idx, keys and signs are one broadcast load per group.  Emissions,
// tail and first are limb-major with the chunk index fastest and a lane
// stores its own words directly: whole 32-byte sectors per warp for
// T = 4, half sectors for T = 8, which measured as fast as staged tiles
// on the group add (csrc/group.cu, PERF.md).
#ifndef G16_CFG
#error "compile once per group configuration: -DG16_CFG=0..3 (ops/build.py)"
#endif
#include "field_coop.cuh"

// Blocks of G16_THREADS that must fit an SM (the register cap).  The scan
// holds the accumulator, the prefetched row and the mixed add's
// temporaries: 12 warps for G1 (4 lanes) and Fq2 (8 lanes) keep all of it
// in registers; Fq3 takes about 200 registers a lane (8 warps) beside the
// stack frame of its out-of-line tower product (PERF.md has the tighter
// caps' times, which spill).
#ifndef G16_MINB
#if G16_CFG == 3
#define G16_MINB 2
#else
#define G16_MINB 3
#endif
#endif
#define G16_THREADS 128


// internal linkage: every configuration's unit defines these names
namespace {

using O = lanes::Ops<G16_CFG, G16_T>;

// rows: (nrows, 2*D*24) affine rows; idx, keys: (S, B) int32; signs: (S, B)
// uint8 or null.  Outputs: em (3D, 24, S-1, B) run totals emitted before
// step s (the accumulator entering step s), em_valid (S-1, B), tail and
// first (3D, 24, B), haschg (B).
__global__ void __launch_bounds__(G16_THREADS, G16_MINB)
k_msm_scan(const uint32_t* __restrict__ rows, const int32_t* __restrict__ idx,
           const int32_t* __restrict__ keys,
           const uint8_t* __restrict__ signs, int S, long long B,
           uint32_t* __restrict__ em, uint8_t* __restrict__ em_valid,
           uint32_t* __restrict__ tail, uint32_t* __restrict__ first,
           uint8_t* __restrict__ haschg) {
  constexpr int D = O::D, W = O::W, F = 2 * D * NW;
  // Every shuffle names the whole warp, so no group leaves early: past
  // the end a group walks the last chunk again and `live` keeps it from
  // storing.
  const long long g =
      (blockIdx.x * (long long)G16_THREADS + threadIdx.x) / G16_T;
  const bool live = g < B;
  const long long b = live ? g : B - 1;
  O::Ln L;
  O::init(L);

  // this lane's words of the affine row of step s
  auto fetch = [&](int s, O::El& x, O::El& y) {
    const uint32_t* row =
        rows + (long long)idx[s * B + b] * F + L.li * W;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        x.c[i].v[w] = row[i * NW + w];
        y.c[i].v[w] = row[(D + i) * NW + w];
      }
  };
  // the infinity flag of an affine row (taken before the negation), and
  // y -> p - y for a negative digit
  auto sign_lift = [&](int s, O::El& y) -> bool {
    const bool inf = O::is_zero(L, y);
    if (signs != nullptr) {
      O::El zero, ny;
      O::zero(zero);
      O::sub(L, ny, zero, y);
      O::select(y, signs[s * B + b] != 0, ny, y);
    }
    return inf;
  };
  // (x : y : 1), or the identity for an infinity row
  auto lift = [&](bool inf, const O::El& x, const O::El& y, O::Pt& r) {
    O::Pt ident;
    O::identity(L, ident);
    r.X = x;
    r.Y = y;
    O::one(L, r.Z);
    O::select(r, inf, ident, r);
  };

  O::Pt acc, next;
  O::El x, y, nx, ny;
  // the first partial is stored where it arises (at most once a chunk),
  // so it holds no registers through the loop
  O::identity(L, next);
  if (live) O::pt_store(L, next, first, B, b);
  fetch(0, x, y);
  lift(sign_lift(0, y), x, y, acc);
  if (S > 1) fetch(1, nx, ny);
  int prevk = keys[b];
  bool chg = false;
  const long long es = (long long)(S - 1) * B;
  for (int s = 1; s < S; ++s) {
    x = nx;
    y = ny;
    if (s + 1 < S) fetch(s + 1, nx, ny);    // lands during this step's add
    const int k = keys[s * B + b];
    const bool same = (k == prevk);
    if (live) {
      O::pt_store(L, acc, em + (long long)(s - 1) * B, es, b);
      if (L.li == 0) em_valid[(s - 1) * B + b] = (!same && chg) ? 1 : 0;
      if (!same && !chg) O::pt_store(L, acc, first, B, b);
    }
    const bool inf = sign_lift(s, y);
    O::ec_mixed_add(L, next, acc, x, y);
    O::select(acc, inf, acc, next);         // an infinity row adds nothing
    lift(inf, x, y, next);
    O::select(acc, same, acc, next);        // a new key restarts the run
    chg = chg || !same;
    prevk = k;
  }
  if (live) {
    O::pt_store(L, acc, tail, B, b);
    if (L.li == 0) haschg[b] = chg ? 1 : 0;
  }
}

}  // namespace

#define G16_NAME2(a, b) a##b
#define G16_NAME(a, b) G16_NAME2(a, b)

// One entry point per group configuration G16_CFG (csrc/group.cu).
extern "C" int G16_NAME(g16_msm_scan_, G16_CFG)(
    const void* rows, const void* idx, const void* keys, const void* signs,
    int S, long long B, void* em, void* em_valid, void* tail, void* first,
    void* haschg, void* stream) {
  if (B <= 0) return 0;
  if (S < 1) return (int)cudaErrorInvalidValue;
  const int threads = G16_THREADS;
  const long long per_block = threads / G16_T;     // chunks per block
  const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
  k_msm_scan<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)idx, (const int32_t*)keys,
      (const uint8_t*)signs, S, B, (uint32_t*)em, (uint8_t*)em_valid,
      (uint32_t*)tail, (uint32_t*)first, (uint8_t*)haschg);
  return (int)cudaGetLastError();
}
