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
// it changes, and writes the run totals, first partial, tail and
// has-changed flag that the stitch and scatter stages consume.
//
// The step.  The accumulator only ever adds an affine row, so it is held
// in XYZZ coordinates (X, Y, ZZ, ZZZ) for (X / ZZ, Y / ZZZ), the identity
// ZZ = ZZZ = 0, and a step is the mixed add madd-2008-s: 10 Fq products
// in four layers of independent ones (2, 2, 3, 3), no product by the
// curve's a or 3b, and about a third of the complete formula's tower adds
// (ops/ec.py CurveOps.xyzz_mixed_add is its plain version).  A group
// swaps the operands of those ten products for its two other jobs, so
// that the warp runs one stream of instructions with no branch:
//  - where its run ends (the key changes and the sum is dropped), the
//    first three products are the accumulator's projective form, the
//    layout the carry chain and the reduction take: (X ZZZ : Y ZZ :
//    ZZ ZZZ), the identity as (0 : 1 : 0), stored as the run total (em,
//    where em_valid is set; nothing is written elsewhere) or the first
//    partial (first, at the first key change).  The tail is converted
//    once after the loop.  A conversion costs no product.
//  - where the accumulator equals the row, the one input madd-2008-s gets
//    wrong (the group's vote on P = R = 0), the last eight products are
//    the affine doubling mdbl-2008-s-1 of the row (V = U^2, XX = x^2;
//    W = U V, S = x V, M^2; y W, M (S - X3)), with M = 3 x^2 + a.  Real
//    keys never repeat a point so; the benchmark's tiled keys do on a
//    small share of steps.
// Selects finish the step: an infinity row adds nothing, a new key
// restarts the run at the lifted row (x, y, 1, 1) or at the identity
// (1, 1, 0, 0) for an infinity row, and the identity plus a row is the
// row (a run that began on an infinity row).  A row equal to the negated
// accumulator gives ZZ = ZZZ = 0 by itself.  g_tally counts the
// warp-steps in which some group converted and in which some group
// doubled.  A first design ran the conversion and the doubling as
// branches that a warp took when one of its groups needed them: the Fq2
// scan ran 1.4x (runs of 32 points) to 5.9x (tiled multiples) slower than
// the complete formula's, and the G1 and Fq2 scans spilled (PERF.md).
//
// Bound on the H100: 32-bit integer multiply-adds.  A G1 step is 10 Fq
// products (about 23k multiply-adds, 1.4 ns at 16.75e12/s) against 192 B
// of point row read (0.06 ns at 3.35 TB/s): operations bound it, over 20x
// over the bytes.  One thread per chunk kept accumulator, operand and
// temporaries (2 to 8 KB) in local memory at 8 warps an SM, 5 to 13 times
// over the bound.  Spread over T lanes (4 for G1, 8 for the towers) the
// state is registers only and 12 warps are resident (8 for Fq3): the
// step settles the new X and ZZ after its third layer and fetches the
// next row there, which keeps the live set under the register cap (158
// registers for G1, 150 for Fq2; fetching at the top of the step took
// 162-166 and ran 4 % slower over G1).  Every lane of a warp runs the
// same instructions (every shuffle names the whole warp); only the stores
// are conditional.
//
// Memory access: the T lanes of a group read the 24 consecutive words of
// each coefficient of the chunk's next row together (one to two 128-byte
// lines), through the sorted index straight from the (n, 2*D*24)
// file-layout rows (no gathered copy), and the row of step s + 1 is
// fetched before the fourth layer of step s so the random access hides
// under it.  idx, keys and signs are one broadcast load per group.  Run totals,
// tail and first are limb-major with the chunk index fastest and a lane
// stores its own words directly: whole 32-byte sectors per warp for
// T = 4, half sectors for T = 8, which measured as fast as staged tiles
// on the group add (csrc/group.cu, PERF.md).
#ifndef G16_CFG
#error "compile once per group configuration: -DG16_CFG=0..3 (ops/build.py)"
#endif
#include "field_coop.cuh"

// Blocks of G16_THREADS that must fit an SM (the register cap).  The scan
// holds the XYZZ accumulator, the prefetched row and the step's
// temporaries: 12 warps for G1 (4 lanes) and Fq2 (8 lanes) keep all of it
// in registers; Fq3 takes about 230 registers a lane (8 warps) beside the
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

// Warp-steps of every launch of this configuration's scan on the device
// in which some group doubled and in which some group converted a run
// total; a module variable, so that counting holds no allocation of the
// caller's (read by g16_msm_scan_tally_<cfg>).
__device__ unsigned long long g_tally[2];

// rows: (nrows, 2*D*24) affine rows; idx, keys: (S, B) int32; signs: (S, B)
// uint8 or null.  Outputs: em (3D, 24, S-1, B) the run total that ends
// before step s, written only where em_valid (S-1, B) is set; tail and
// first (3D, 24, B); haschg (B).  Lane 0 of each warp adds its counts to
// g_tally at the end.
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

  O::Pz acc;
  O::Pt out;
  O::El x, y, nx, ny;
  // the first partial is stored where it arises (at most once a chunk),
  // so it holds no registers through the loop
  O::identity(L, out);
  if (live) O::pt_store(L, out, first, B, b);
  fetch(0, x, y);
  O::xyzz_lift(L, acc, sign_lift(0, y), x, y);
  if (S > 1) fetch(1, nx, ny);
  int prevk = keys[b];
  bool chg = false;
  unsigned long long n_dbl = 0, n_conv = 0;
  const long long es = (long long)(S - 1) * B;
  for (int s = 1; s < S; ++s) {
    x = nx;
    y = ny;
    const int k = keys[s * B + b];
    const bool same = (k == prevk);
    const bool end = live && !same;         // a run ends: store its total
    if (live && L.li == 0) em_valid[(s - 1) * B + b] = (end && chg) ? 1 : 0;
    uint32_t* const dst = chg ? em + (long long)(s - 1) * B : first;
    const long long stride = chg ? es : B;
    const bool inf = sign_lift(s, y);
    const bool ainf = O::is_zero(L, acc.ZZ);
    // what replaces the accumulator besides the sum: the row where the run
    // restarts or the accumulator is the identity, the identity where it
    // restarts on an infinity row; the accumulator stays where an infinity
    // row adds nothing
    const bool take_row = !inf && (!same || ainf), take_id = !same && inf;
    const bool keep = same && inf;
    auto settle = [&](O::El& now, const O::El& v, const O::El& row,
                      bool one_in_id) {
      O::El t, c;
      O::select(t, take_row, row, v);
      if (one_in_id) O::one(L, c);
      else O::zero(c);
      O::select(t, take_id, c, t);
      O::select(now, keep, now, t);
    };
    // first layer: U2 = x ZZ1, S2 = y ZZZ1 | X1 ZZZ1, Y1 ZZ1 where a run
    // ends (its projective X and Y)
    O::El s0, t0, s1, t1, m1a, m1b;
    O::select(s0, end, acc.X, x);
    O::select(t0, end, acc.ZZZ, acc.ZZ);
    O::select(s1, end, acc.Y, y);
    O::select(t1, end, acc.ZZ, acc.ZZZ);
    O::mul2(L, m1a, s0, t0, m1b, s1, t1);
    O::El e, r;
    O::sub(L, e, m1a, acc.X);               // P
    O::sub(L, r, m1b, acc.Y);               // R
    if (end) {                              // the identity as (0 : 1 : 0)
      O::El c;
      O::zero(c);
      O::select(m1a, ainf, c, m1a);
      O::one(L, c);
      O::select(m1b, ainf, c, m1b);
      O::el_store(L, m1a, dst, 0, stride, b);
      O::el_store(L, m1b, dst, D, stride, b);
    }
    // the accumulator equals the row: the doubling of the row instead
    bool z = true;
#pragma unroll
    for (int i = 0; i < D; ++i)
      z = z && lanes::lane_is_zero(e.c[i]) && lanes::lane_is_zero(r.c[i]);
    const bool dbl =
        lanes::group_all(L, z) && live && same && !inf && !ainf;
    // second layer: PP = P^2, RR = R^2 | V = U^2, XX = x^2 (U = 2y) |
    // ZZ1 ZZZ1 where a run ends (its projective Z)
    O::add(L, s0, y, y);
    O::select(e, dbl, s0, e);               // P | U
    O::select(s0, end, acc.ZZ, e);
    O::select(t0, end, acc.ZZZ, e);
    O::select(s1, dbl, x, r);
    O::El m2a, m2b;
    O::mul2(L, m2a, s0, t0, m2b, s1, s1);
    if (end) {
      O::El c;
      O::zero(c);
      O::select(c, ainf, c, m2a);
      O::el_store(L, c, dst, 2 * D, stride, b);
    }
    // third layer: PPP = P PP, Q = X1 PP, ZZ3 = ZZ1 PP | W = U V, S = x V,
    // M^2 (M = 3 XX + a)
    O::El m;
    O::add(L, m, m2b, m2b);
    O::add(L, m, m, m2b);
    {
      O::F ca;
#pragma unroll
      for (int w = 0; w < W; ++w) ca.v[w] = L.a[w];
      lanes::fp_add(L, m.c[O::IA], m.c[O::IA], ca);
    }
    O::select(s0, dbl, x, acc.X);
    O::select(s1, dbl, m, acc.ZZ);
    O::select(t1, dbl, m, m2a);
    O::select(r, dbl, m, r);                // R | M for the fourth layer
    O::El m3a, m3b, m3c;
    O::mul3(L, m3a, e, m2a, m3b, s0, m2a, m3c, s1, t1);
    if (s + 1 < S) fetch(s + 1, nx, ny);    // lands during the fourth layer
    // X3 = RR - PPP - 2Q | M^2 - 2S, and ZZ3 | V: the new X and ZZ (acc.X
    // and acc.ZZ are not read again this step)
    O::sub(L, t0, m2b, m3a);
    O::select(t0, dbl, m3c, t0);
    O::add(L, t1, m3b, m3b);
    O::sub(L, t0, t0, t1);
    O::sub(L, t1, m3b, t0);                 // Q - X3 | S - X3
    O::El e1;
    O::one(L, e1);
    settle(acc.X, t0, x, true);
    O::select(m3c, dbl, m2a, m3c);
    settle(acc.ZZ, m3c, e1, false);
    // fourth layer: Y1 PPP | y W, ZZZ3 = ZZZ1 PPP, R (Q - X3) | M (S - X3)
    O::select(s0, dbl, y, acc.Y);
    O::El m4a, m4b, m4c;
    O::mul3(L, m4a, s0, m3a, m4b, acc.ZZZ, m3a, m4c, r, t1);
    O::sub(L, t0, m4c, m4a);                // Y3
    settle(acc.Y, t0, y, true);
    O::select(m4b, dbl, m3a, m4b);          // ZZZ3 | W
    O::one(L, e1);
    settle(acc.ZZZ, m4b, e1, false);
    n_dbl += __any_sync(lanes::FULL, dbl) ? 1 : 0;
    n_conv += __any_sync(lanes::FULL, end) ? 1 : 0;
    chg = chg || !same;
    prevk = k;
  }
  O::xyzz_to_proj(L, out, acc);
  if (live) {
    O::pt_store(L, out, tail, B, b);
    if (L.li == 0) haschg[b] = chg ? 1 : 0;
  }
  if ((threadIdx.x & 31) == 0 && (n_dbl | n_conv)) {
    atomicAdd(&g_tally[0], n_dbl);
    atomicAdd(&g_tally[1], n_conv);
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

// The current device's tally of this configuration's scans (two words:
// doubling, conversion) into out; waits for the device.
extern "C" int G16_NAME(g16_msm_scan_tally_, G16_CFG)(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_tally, sizeof(g_tally));
}
