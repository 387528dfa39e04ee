// Device field and group layer with one element spread over T lanes of a
// warp (T = 4: 6 words a lane, T = 8: 3 words a lane): 753-bit Montgomery
// form over 24 x 32-bit words (R = 2^768, the file format's radix), the
// Fq2 / Fq3 towers, the complete projective group law of
// Renes-Costello-Batina 2016 (EPRINT 2015/1060, Algorithms 1-3, general a)
// exactly as the plain PyTorch version (ops/ec.py) writes it, and the
// bucket scan's XYZZ points (ops/ec.py CurveOps.xyzz_*; the step itself is
// in csrc/msm_scan.cu).  Every value is canonical (< p) on entry and exit
// of every function, so a kernel and its plain version agree word for
// word.
//
// What bounds the group and scan kernels on the H100 is where the state
// lives as much as the arithmetic: a projective point with the formula's
// temporaries is several times a thread's 255 registers, so one thread per
// point keeps it in local memory and leaves 8 warps on an SM.  Here a
// group of T neighbouring lanes holds every element together (lane l owns
// words l*W .. l*W + W - 1, W = 24 / T) and runs the whole formula in step:
// the live set is 1/T per lane and fits the register file (no stack frame
// over Fq and Fq2), and 12 to 16 warps are resident.
//
//  - Product (fp_mul_n): cooperative CIOS.  Per word a_i: broadcast a_i
//    from the lane that holds it (shuffle), every lane multiplies it into
//    its W words of b, lane 0 gives the reduction factor m (shuffle),
//    every lane adds m * p for its words, and the accumulator moves down
//    one word: each lane's lowest word goes to the lane below (shuffle
//    down).  Carries between lanes are not rippled per step: a lane keeps
//    two overflow words above its W, folds them into the lane above once
//    at the end, and one ballot resolve finishes.  A lane's accumulator
//    is two arrays (Acc) so that each 64-bit word product always lands on
//    the same register pair: a lo:hi pair of multiply-adds then runs as
//    one wide multiply-add with carry, with no moves between steps.  N
//    independent products run in one loop to hide the shuffle latency.
//    The loop over the lanes that hold a_i is not unrolled, so a product
//    is a few steps of code and a formula stays in the instruction cache.
//  - Tower product over Fq2 (fq2_mul): no Karatsuba.  The coefficients
//    c0 = a0 b0 + alpha a1 b1 and c1 = a0 b1 + a1 b0 are two sums of
//    products in one CIOS loop: per word i the lanes broadcast a0_i and
//    a1_i once and add both products into each of two accumulators, which
//    then take their own m.  As many multiply-adds as Karatsuba's three
//    products (six rows a step), but six shuffles a step against nine, two
//    finishes against three, and no modular adds around the products:
//    alpha b1 is formed once and left unreduced.  Over Fq3 the product
//    stays Karatsuba, out of line.
//  - Add, subtract, compare (coop_add, resolve): each lane adds its
//    words; its carry out is a generate bit and "all my words are ones" a
//    propagate bit; two ballots collect them, and the carries into the
//    lanes are the carry bits of one addition on the ballot words.  The
//    carry out of the group is the comparison (s >= p, a >= b).
//  - Every shuffle and ballot names the whole warp (a mask known at
//    compile time costs one instruction; a computed group mask costs a
//    convergence barrier around each), so a kernel keeps all 32 lanes in
//    step: no group leaves early, the ragged edge computes on a clamped
//    index and skips its stores, and data-dependent choices are selects.
//  - Each lane loads its own words of the constants to registers once per
//    kernel (Lane::init): lanes that index __constant__ memory
//    differently are serialised.
//
// tests/test_torch_coop.py holds a word-for-word model of this file's
// arithmetic that runs without a card.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "g16_constants.cuh"  // G16_P, G16_NINV, G16_ONE, G16_B3, G16_A

#define NW 24

// Lanes per element (G16_T) and independent products per cooperative loop
// (G16_ILP) of group configuration G16_CFG, chosen by measurement at the
// main path's shapes (tune_lanes.py; PERF.md has every variant's time):
// the G1 configurations run fastest on 4 lanes (half the shuffles per
// element, whole 32-byte sectors per warp access), the Fq2 and Fq3
// towers on 8 (half the registers a lane).
#ifndef G16_T
#if G16_CFG == 0 || G16_CFG == 2
#define G16_T 4
#else
#define G16_T 8
#endif
#endif
#ifndef G16_ILP
#if G16_T == 4
#define G16_ILP 2
#else
#define G16_ILP 3
#endif
#endif

namespace lanes {

// -- carry-chain instructions ---------------------------------------------------

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo:hi += a * b as one pair of a carry chain (ptxas fuses a pair on the
// same operands into one wide multiply-add with carry); the first starts
// a chain, the second continues one.
__device__ __forceinline__ void mad_wide_cc(uint32_t& lo, uint32_t& hi,
                                            uint32_t a, uint32_t b) {
  asm volatile(
      "mad.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
      : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_wide_cc(uint32_t& lo, uint32_t& hi,
                                             uint32_t a, uint32_t b) {
  asm volatile(
      "madc.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;"
      : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}

// -- one lane's share of an element, and of the constants -------------------------

constexpr uint32_t FULL = 0xFFFFFFFFu;     // every shuffle names the warp

template <int T>
struct Fp {
  uint32_t v[NW / T];
};

// Per-thread context: where this lane sits in its group, and its words of
// the prime P and of group configuration CFG's constants.
template <int P, int T>
struct Lane {
  static constexpr int W = NW / T;
  static_assert(NW % T == 0 && W >= 2 && T <= 16, "T in 4, 8");
  uint32_t p[W];      // modulus
  uint32_t one[W];    // R mod p
  uint32_t b3[W];     // the nonzero coefficient of 3b (Montgomery form)
  uint32_t a[W];      // the nonzero coefficient of a (Montgomery form)
  uint32_t ninv;      // -p^-1 mod 2^32
  int li;             // lane index within the group
  int gb;             // the group's first lane within the warp

  __device__ __forceinline__ void init(int cfg) {
    const int lane = threadIdx.x & 31;
    li = lane & (T - 1);
    gb = lane - li;
    ninv = G16_NINV[P];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      p[w] = G16_P[P][li * W + w];
      one[w] = G16_ONE[P][li * W + w];
      b3[w] = G16_B3[cfg][li * W + w];
      a[w] = G16_A[cfg][li * W + w];
    }
  }
};

// -- carries between lanes ---------------------------------------------------------

// r: this lane's words after its local add, g: the carry out of that add.
// Adds the carry that enters this lane (cin0 enters lane 0) and returns
// the carry out of the group.
template <int P, int T>
__device__ __forceinline__ uint32_t resolve(const Lane<P, T>& L,
                                            uint32_t (&r)[NW / T], uint32_t g,
                                            uint32_t cin0) {
  constexpr int W = NW / T;
  uint32_t ones = r[0];
#pragma unroll
  for (int w = 1; w < W; ++w) ones &= r[w];
  constexpr uint32_t GM = (1u << T) - 1u;
  const uint32_t G = (__ballot_sync(FULL, g != 0u) >> L.gb) & GM;
  const uint32_t Q = (__ballot_sync(FULL, ones == 0xFFFFFFFFu) >> L.gb) & GM;
  const uint32_t X = G | Q;
  const uint32_t cv = (X + G + cin0) ^ X ^ G;   // bit l: carry into lane l
  r[0] = add_cc(r[0], (cv >> L.li) & 1u);
#pragma unroll
  for (int w = 1; w < W - 1; ++w) r[w] = addc_cc(r[w], 0u);
  r[W - 1] = addc(r[W - 1], 0u);
  return (cv >> T) & 1u;
}

// r = a + b + cin0 over the group (low 768 bits); returns the carry out.
template <int P, int T>
__device__ __forceinline__ uint32_t coop_add(const Lane<P, T>& L,
                                             uint32_t (&r)[NW / T],
                                             const uint32_t (&a)[NW / T],
                                             const uint32_t (&b)[NW / T],
                                             uint32_t cin0) {
  constexpr int W = NW / T;
  uint32_t s[W];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int w = 1; w < W; ++w) s[w] = addc_cc(a[w], b[w]);
  const uint32_t g = addc(0u, 0u);
  const uint32_t out = resolve(L, s, g, cin0);
#pragma unroll
  for (int w = 0; w < W; ++w) r[w] = s[w];
  return out;
}

// s - p if s >= p else s (s < 2p): s + ~p + 1, its carry out is the vote.
template <int P, int T>
__device__ __forceinline__ void cond_sub_p(const Lane<P, T>& L, Fp<T>& r,
                                           const uint32_t (&s)[NW / T]) {
  constexpr int W = NW / T;
  uint32_t np[W], d[W];
#pragma unroll
  for (int w = 0; w < W; ++w) np[w] = ~L.p[w];
  const uint32_t ge = coop_add(L, d, s, np, 1u);
#pragma unroll
  for (int w = 0; w < W; ++w) r.v[w] = ge ? d[w] : s[w];
}

// -- prime field -------------------------------------------------------------------

template <int P, int T>
__device__ __forceinline__ void fp_add(const Lane<P, T>& L, Fp<T>& r,
                                       const Fp<T>& a, const Fp<T>& b) {
  uint32_t s[NW / T];
  coop_add(L, s, a.v, b.v, 0u);             // a + b < 2p < 2^768
  cond_sub_p(L, r, s);
}

template <int P, int T>
__device__ __forceinline__ void fp_sub(const Lane<P, T>& L, Fp<T>& r,
                                       const Fp<T>& a, const Fp<T>& b) {
  constexpr int W = NW / T;
  uint32_t nb[W], d[W], back[W];
#pragma unroll
  for (int w = 0; w < W; ++w) nb[w] = ~b.v[w];
  const uint32_t no_borrow = coop_add(L, d, a.v, nb, 1u);
#pragma unroll
  for (int w = 0; w < W; ++w) back[w] = no_borrow ? 0u : L.p[w];
  coop_add(L, r.v, d, back, 0u);            // a < b: add p back
}

// k * a mod p for a small compile-time k, by a double-and-add chain.
template <int K, int P, int T>
__device__ __forceinline__ void fp_small(const Lane<P, T>& L, Fp<T>& r,
                                         const Fp<T>& a) {
  if constexpr (K == 1) {
    r = a;
  } else {
    Fp<T> h;
    fp_small<K / 2>(L, h, a);
    fp_add(L, h, h, h);
    if constexpr (K & 1) fp_add(L, h, h, a);
    r = h;
  }
}

// a vote over the group: every lane of it holds `mine`
template <int P, int T>
__device__ __forceinline__ bool group_all(const Lane<P, T>& L, bool mine) {
  constexpr uint32_t GM = (1u << T) - 1u;
  return ((__ballot_sync(FULL, mine) >> L.gb) & GM) == GM;
}

// this lane's words are all zero (vote over the group in the callers)
template <int T>
__device__ __forceinline__ bool lane_is_zero(const Fp<T>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int w = 0; w < NW / T; ++w) acc |= a.v[w];
  return acc == 0u;
}

template <int T>
__device__ __forceinline__ void fp_zero(Fp<T>& r) {
#pragma unroll
  for (int w = 0; w < NW / T; ++w) r.v[w] = 0u;
}

template <int P, int T>
__device__ __forceinline__ void fp_one(const Lane<P, T>& L, Fp<T>& r) {
#pragma unroll
  for (int w = 0; w < NW / T; ++w) r.v[w] = L.one[w];
}

template <int T>
__device__ __forceinline__ void fp_select(Fp<T>& r, bool c, const Fp<T>& a,
                                          const Fp<T>& b) {
#pragma unroll
  for (int w = 0; w < NW / T; ++w) r.v[w] = c ? a.v[w] : b.v[w];
}

// One product's accumulator in a lane.  Every 64-bit word product lands on
// a fixed pair of words, which is what lets a lo:hi pair of multiply-adds
// run as one wide instruction with no register moves: `ev` holds word
// positions 0 .. W+1 and takes the products of the lane's even words
// (pairs (0,1), (2,3), ...), `od` holds positions 1 .. W+1 (od[k] is
// position k + 1) and takes the odd ones (pairs (1,2), (3,4), ...).
template <int W>
struct Acc {
  uint32_t ev[W + 2];
  uint32_t od[W + 1];
};

// acc += x * y[0 .. W-1]: one carry chain per accumulator, each ending in
// the words above its last pair.
template <int W>
__device__ __forceinline__ void mad_row(Acc<W>& t, uint32_t x,
                                        const uint32_t (&y)[W]) {
  mad_wide_cc(t.ev[0], t.ev[1], x, y[0]);
#pragma unroll
  for (int j = 2; j < W; j += 2) madc_wide_cc(t.ev[j], t.ev[j + 1], x, y[j]);
  if constexpr (W % 2 == 0) t.ev[W] = addc_cc(t.ev[W], 0u);
  t.ev[W + 1] = addc(t.ev[W + 1], 0u);
  mad_wide_cc(t.od[0], t.od[1], x, y[1]);
#pragma unroll
  for (int j = 3; j < W; j += 2) madc_wide_cc(t.od[j - 1], t.od[j], x, y[j]);
  if constexpr (W % 2 == 1) t.od[W - 1] = addc_cc(t.od[W - 1], 0u);
  t.od[W] = addc(t.od[W], 0u);
}

// One CIOS step of one product: t += ai * b, t += m * p with m from lane
// 0, then down one word.  The lowest word goes to the lane below and
// enters there at position W - 1; `od` (positions 1 ..) becomes the new
// `ev` and takes the old ev[1] at position 0 in the same carry chain; the
// old ev[2 ..] is the new `od`.
template <int P, int T>
__device__ __forceinline__ void cios_step(const Lane<P, T>& L,
                                          Acc<NW / T>& t, uint32_t ai,
                                          const uint32_t (&b)[NW / T]) {
  constexpr int W = NW / T;
  mad_row<W>(t, ai, b);
  const uint32_t m = __shfl_sync(FULL, t.ev[0] * L.ninv, 0, T);
  mad_row<W>(t, m, L.p);
  uint32_t up = __shfl_down_sync(FULL, t.ev[0], 1, T);
  if (L.li == T - 1) up = 0u;
  Acc<W> n;
  n.ev[0] = add_cc(t.od[0], t.ev[1]);
#pragma unroll
  for (int k = 1; k <= W; ++k)
    n.ev[k] = addc_cc(t.od[k], k == W - 1 ? up : 0u);
  n.ev[W + 1] = addc(0u, 0u);
#pragma unroll
  for (int k = 0; k < W; ++k) n.od[k] = t.ev[k + 2];
  n.od[W] = 0u;
  t = n;
}

// N independent Montgomery products r[n] = a[n] * b[n] / R mod p.  Every
// a and b is read before any r is written, so r may alias them.  Its
// finish has a twin in acc_finish (below): change the two together.
template <int N, int P, int T>
__device__ __forceinline__ void fp_mul_n(const Lane<P, T>& L, Fp<T>* r,
                                         const Fp<T>* a, const Fp<T>* b) {
  constexpr int W = NW / T;
  Acc<W> t[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < W + 2; ++j) t[n].ev[j] = 0u;
#pragma unroll
    for (int j = 0; j < W + 1; ++j) t[n].od[j] = 0u;
  }
  // An iteration covers W words of a for even W and 2 W for odd W, so
  // that the accumulators are back in their roles at the loop's end.
  constexpr int LANES_PER_IT = (W % 2 == 0) ? 1 : 2;
  static_assert(T % LANES_PER_IT == 0, "whole iterations");
#pragma unroll 1
  for (int src = 0; src < T; src += LANES_PER_IT) {   // the lanes that hold a_i
#pragma unroll
    for (int k = 0; k < LANES_PER_IT * W; ++k) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const uint32_t ai = __shfl_sync(FULL, a[n].v[k % W], src + k / W, T);
        cios_step(L, t[n], ai, b[n].v);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    // merge the two accumulators, fold the overflow words into the lane
    // above, resolve, reduce
    uint32_t u[W + 2];
    u[0] = t[n].ev[0];
    u[1] = add_cc(t[n].ev[1], t[n].od[0]);
#pragma unroll
    for (int j = 2; j <= W; ++j) u[j] = addc_cc(t[n].ev[j], t[n].od[j - 1]);
    u[W + 1] = addc(t[n].ev[W + 1], t[n].od[W]);
    uint32_t o0 = __shfl_up_sync(FULL, u[W], 1, T);
    uint32_t o1 = __shfl_up_sync(FULL, u[W + 1], 1, T);
    if (L.li == 0) o0 = o1 = 0u;
    uint32_t s[W];
    s[0] = add_cc(u[0], o0);
    s[1] = addc_cc(u[1], o1);
#pragma unroll
    for (int j = 2; j < W; ++j) s[j] = addc_cc(u[j], 0u);
    const uint32_t g = addc(0u, 0u);
    resolve(L, s, g, 0u);                   // (ab + mp) / R < 2p
    cond_sub_p(L, r[n], s);
  }
}

// N products in batches of G16_ILP.
template <int N, int P, int T>
__device__ __forceinline__ void fp_mul_list(const Lane<P, T>& L, Fp<T>* r,
                                            const Fp<T>* a, const Fp<T>* b) {
  constexpr int K = N < G16_ILP ? N : G16_ILP;
  fp_mul_n<K>(L, r, a, b);
  if constexpr (N > K) fp_mul_list<N - K>(L, r + K, a + K, b + K);
}

// -- group configurations ----------------------------------------------------------
// CFG 0: MNT4753 G1 over Fq = P_B; a = 2.
// CFG 1: MNT4753 G2 over Fq2 (alpha 13); a = (26, 0), b3 = (0, c).
// CFG 2: MNT6753 G1 over Fq = P_A; a = 11.
// CFG 3: MNT6753 G2 over Fq3 (alpha 11); a = (0, 0, 11), b3 = (c, 0, 0).
// IA: the index of a's nonzero coefficient (Lane::a).

template <int CFG>
struct Params;
template <>
struct Params<0> {
  static constexpr int P = 1, D = 1, AL = 13, IA = 0;
};
template <>
struct Params<1> {
  static constexpr int P = 1, D = 2, AL = 13, IA = 0;
};
template <>
struct Params<2> {
  static constexpr int P = 0, D = 1, AL = 11, IA = 0;
};
template <>
struct Params<3> {
  static constexpr int P = 0, D = 3, AL = 11, IA = 2;
};

// -- extension tower Fq^D = Fq[v]/(v^D - AL), D in {1, 2, 3} -----------------------

template <int T, int D>
struct Ext {
  Fp<T> c[D];
};

// K * a as a 768-bit integer, not reduced (K a < K p < 2^768): each lane
// multiplies its words, hands its carry word to the lane above, and one
// resolve finishes.
template <int K, int P, int T>
__device__ __forceinline__ void fp_times(const Lane<P, T>& L, Fp<T>& r,
                                         const Fp<T>& a) {
  constexpr int W = NW / T;
  uint32_t s[W], c = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t x = (uint64_t)a.v[w] * K + c;
    s[w] = (uint32_t)x;
    c = (uint32_t)(x >> 32);
  }
  uint32_t cin = __shfl_up_sync(FULL, c, 1, T);
  if (L.li == 0) cin = 0u;
  s[0] = add_cc(s[0], cin);
#pragma unroll
  for (int w = 1; w < W; ++w) s[w] = addc_cc(s[w], 0u);
  const uint32_t g = addc(0u, 0u);
  resolve(L, s, g, 0u);
#pragma unroll
  for (int w = 0; w < W; ++w) r.v[w] = s[w];
}

// The end of a product, as fp_mul_n ends: merge the two accumulators,
// fold the overflow words into the lane above, resolve, and subtract p
// once (the sum is below 2p).  fp_mul_n keeps its own copy: calling this
// one there moved ptxas's schedule of the G1 units.
template <int P, int T>
__device__ __forceinline__ void acc_finish(const Lane<P, T>& L, Fp<T>& r,
                                           const Acc<NW / T>& t) {
  constexpr int W = NW / T;
  uint32_t u[W + 2];
  u[0] = t.ev[0];
  u[1] = add_cc(t.ev[1], t.od[0]);
#pragma unroll
  for (int j = 2; j <= W; ++j) u[j] = addc_cc(t.ev[j], t.od[j - 1]);
  u[W + 1] = addc(t.ev[W + 1], t.od[W]);
  uint32_t o0 = __shfl_up_sync(FULL, u[W], 1, T);
  uint32_t o1 = __shfl_up_sync(FULL, u[W + 1], 1, T);
  if (L.li == 0) o0 = o1 = 0u;
  uint32_t s[W];
  s[0] = add_cc(u[0], o0);
  s[1] = addc_cc(u[1], o1);
#pragma unroll
  for (int j = 2; j < W; ++j) s[j] = addc_cc(u[j], 0u);
  const uint32_t g = addc(0u, 0u);
  resolve(L, s, g, 0u);
  cond_sub_p(L, r, s);
}

// A product over Fq2 = Fq[v]/(v^2 - K) as two sums of products in one
// cooperative CIOS loop: c0 = a0 b0 + a1 (K b1) and c1 = a0 b1 + a1 b0.
// Per word i both accumulators take the same broadcast words a0_i and
// a1_i, then each its own m (the CIOS step of its second row).  K b1
// stays unreduced, so an accumulator stays below (K + 2) p < 2^768 and
// ends below p (1 + (K + 1) p / R) < 2p: one subtract finishes each
// coefficient.  Every input is read before r is written.
template <int K, int P, int T>
__device__ __forceinline__ void fq2_mul(const Lane<P, T>& L, Ext<T, 2>& r,
                                        const Ext<T, 2>& a,
                                        const Ext<T, 2>& b) {
  constexpr int W = NW / T;
  Fp<T> kb1;
  fp_times<K>(L, kb1, b.c[1]);
  Acc<W> t0 = {}, t1 = {};                  // c0, c1
  // as in fp_mul_n: whole iterations bring the accumulators back in role
  constexpr int LANES_PER_IT = (W % 2 == 0) ? 1 : 2;
  static_assert(T % LANES_PER_IT == 0, "whole iterations");
#pragma unroll 1
  for (int src = 0; src < T; src += LANES_PER_IT) {   // the lanes that hold a_i
#pragma unroll
    for (int k = 0; k < LANES_PER_IT * W; ++k) {
      const uint32_t a0 = __shfl_sync(FULL, a.c[0].v[k % W], src + k / W, T);
      const uint32_t a1 = __shfl_sync(FULL, a.c[1].v[k % W], src + k / W, T);
      mad_row<W>(t0, a1, kb1.v);
      cios_step(L, t0, a0, b.c[0].v);
      mad_row<W>(t1, a1, b.c[0].v);
      cios_step(L, t1, a0, b.c[1].v);
    }
  }
  acc_finish(L, r.c[0], t0);
  acc_finish(L, r.c[1], t1);
}

// The field and curve operations of one group configuration, on T lanes.
template <int CFG, int T>
struct Ops {
  static constexpr int P = Params<CFG>::P, D = Params<CFG>::D,
                       AL = Params<CFG>::AL, IA = Params<CFG>::IA,
                       W = NW / T;
  using Ln = Lane<P, T>;
  using F = Fp<T>;
  using El = Ext<T, D>;

  static __device__ __forceinline__ void init(Ln& L) { L.init(CFG); }

  static __device__ __forceinline__ void add(const Ln& L, El& r, const El& a,
                                             const El& b) {
#pragma unroll
    for (int i = 0; i < D; ++i) fp_add(L, r.c[i], a.c[i], b.c[i]);
  }
  static __device__ __forceinline__ void sub(const Ln& L, El& r, const El& a,
                                             const El& b) {
#pragma unroll
    for (int i = 0; i < D; ++i) fp_sub(L, r.c[i], a.c[i], b.c[i]);
  }
  template <int K>
  static __device__ __forceinline__ void small(const Ln& L, El& r,
                                               const El& a) {
#pragma unroll
    for (int i = 0; i < D; ++i) fp_small<K>(L, r.c[i], a.c[i]);
  }
  static __device__ __forceinline__ void zero(El& r) {
#pragma unroll
    for (int i = 0; i < D; ++i) fp_zero(r.c[i]);
  }
  static __device__ __forceinline__ void one(const Ln& L, El& r) {
    zero(r);
    fp_one(L, r.c[0]);
  }
  static __device__ __forceinline__ bool is_zero(const Ln& L, const El& a) {
    bool z = true;
#pragma unroll
    for (int i = 0; i < D; ++i) z = z && lane_is_zero(a.c[i]);
    return group_all(L, z);
  }
  static __device__ __forceinline__ void select(El& r, bool c, const El& a,
                                                const El& b) {
#pragma unroll
    for (int i = 0; i < D; ++i) fp_select(r.c[i], c, a.c[i], b.c[i]);
  }

  // One tower product: over Fq2 two sums of products in one loop
  // (fq2_mul), over Fq3 Karatsuba with the non-residue folded in
  // (ops/field.py mul_many).  Every input is read before r is written.
  static __device__ __forceinline__ void mul(const Ln& L, El& r, const El& a,
                                             const El& b) {
    if constexpr (D == 3) mul_out(L, r, a, b);
    else mul_inl(L, r, a, b);
  }
  // Over Fq3 the product is out of line: one body a kernel instead of a
  // dozen inlined copies keeps the compiler's front end to seconds (it
  // took minutes); the price is a stack frame for the operands.
  static __device__ __noinline__ void mul_out(const Ln& L, El& r, const El& a,
                                              const El& b) {
    mul_inl(L, r, a, b);
  }
  static __device__ __forceinline__ void mul_inl(const Ln& L, El& r,
                                                 const El& a, const El& b) {
    if constexpr (D == 1) {
      fp_mul_n<1>(L, r.c, a.c, b.c);
    } else if constexpr (D == 2) {
      fq2_mul<AL>(L, r, a, b);
    } else {
      F x[6], y[6], t[6], s;
      x[0] = a.c[0]; y[0] = b.c[0];
      x[1] = a.c[1]; y[1] = b.c[1];
      x[2] = a.c[2]; y[2] = b.c[2];
      fp_add(L, x[3], a.c[0], a.c[1]);
      fp_add(L, y[3], b.c[0], b.c[1]);
      fp_add(L, x[4], a.c[0], a.c[2]);
      fp_add(L, y[4], b.c[0], b.c[2]);
      fp_add(L, x[5], a.c[1], a.c[2]);
      fp_add(L, y[5], b.c[1], b.c[2]);
      fp_mul_list<6>(L, t, x, y);           // t0 t1 t2 u01 u02 u12
      // s01 = u01 - (t0 + t1), s02 = u02 - (t0 + t2), s12 = u12 - (t1 + t2)
      fp_add(L, s, t[0], t[1]);
      fp_sub(L, t[3], t[3], s);
      fp_add(L, s, t[0], t[2]);
      fp_sub(L, t[4], t[4], s);
      fp_add(L, s, t[1], t[2]);
      fp_sub(L, t[5], t[5], s);
      fp_small<AL>(L, s, t[5]);
      fp_add(L, r.c[0], t[0], s);
      fp_small<AL>(L, s, t[2]);
      fp_add(L, r.c[1], t[3], s);
      fp_add(L, r.c[2], t[4], t[1]);
    }
  }

  // Two or three independent tower products.  Over Fq they share one
  // cooperative loop; over a tower each product is already a batch (two
  // Fq2 products in one loop spilled).  No result may be an operand of a
  // later product of the same call.
  static __device__ __forceinline__ void mul2(const Ln& L, El& r0,
                                              const El& a0, const El& b0,
                                              El& r1, const El& a1,
                                              const El& b1) {
    if constexpr (D == 1) {
      F x[2] = {a0.c[0], a1.c[0]}, y[2] = {b0.c[0], b1.c[0]}, t[2];
      fp_mul_list<2>(L, t, x, y);
      r0.c[0] = t[0];
      r1.c[0] = t[1];
    } else {
      mul(L, r0, a0, b0);
      mul(L, r1, a1, b1);
    }
  }
  static __device__ __forceinline__ void mul3(const Ln& L, El& r0,
                                              const El& a0, const El& b0,
                                              El& r1, const El& a1,
                                              const El& b1, El& r2,
                                              const El& a2, const El& b2) {
    if constexpr (D == 1) {
      F x[3] = {a0.c[0], a1.c[0], a2.c[0]},
        y[3] = {b0.c[0], b1.c[0], b2.c[0]}, t[3];
      fp_mul_list<3>(L, t, x, y);
      r0.c[0] = t[0];
      r1.c[0] = t[1];
      r2.c[0] = t[2];
    } else {
      mul(L, r0, a0, b0);
      mul(L, r1, a1, b1);
      mul(L, r2, a2, b2);
    }
  }

  // a * t for the curve coefficient a.
  static __device__ __forceinline__ void mul_a(const Ln& L, El& r,
                                               const El& t) {
    if constexpr (CFG == 0) {
      small<2>(L, r, t);
    } else if constexpr (CFG == 1) {
      small<26>(L, r, t);
    } else if constexpr (CFG == 2) {
      small<11>(L, r, t);
    } else {
      // (11 v^2) * (t0 + t1 v + t2 v^2) = 121 t1 + 121 t2 v + 11 t0 v^2
      F u0, u1, u2;
      fp_small<121>(L, u0, t.c[1]);
      fp_small<121>(L, u1, t.c[2]);
      fp_small<11>(L, u2, t.c[0]);
      r.c[0] = u0;
      r.c[1] = u1;
      r.c[2] = u2;
    }
  }

  // 3b * t0 and 3b * t1 (3b has one nonzero coefficient c: G1 c;
  // MNT4753 G2 (0, c); MNT6753 G2 (c, 0, 0)).
  static __device__ __forceinline__ void mul_b3_2(const Ln& L, El& r0,
                                                  const El& t0, El& r1,
                                                  const El& t1) {
    F x[2 * D], y[2 * D], u[2 * D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      x[i] = t0.c[i];
      x[D + i] = t1.c[i];
    }
#pragma unroll
    for (int i = 0; i < 2 * D; ++i)
#pragma unroll
      for (int w = 0; w < W; ++w) y[i].v[w] = L.b3[w];
    fp_mul_list<2 * D>(L, u, y, x);
    fold_b3(L, r0, u);
    fold_b3(L, r1, u + D);
  }
  // u[i] = c * t_i  ->  the tower product (3b) * t
  static __device__ __forceinline__ void fold_b3(const Ln& L, El& r,
                                                 const F* u) {
    if constexpr (CFG == 1) {
      // (c v) * (t0 + t1 v) = alpha c t1 + c t0 v
      fp_small<AL>(L, r.c[0], u[1]);
      r.c[1] = u[0];
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) r.c[i] = u[i];
    }
  }

  // -- points ------------------------------------------------------------------------

  struct Pt {
    El X, Y, Z;
  };

  static __device__ __forceinline__ void identity(const Ln& L, Pt& R) {
    zero(R.X);
    one(L, R.Y);
    zero(R.Z);
  }

  static __device__ __forceinline__ void select(Pt& r, bool c, const Pt& a,
                                                const Pt& b) {
    select(r.X, c, a.X, b.X);
    select(r.Y, c, a.Y, b.Y);
    select(r.Z, c, a.Z, b.Z);
  }

  // Coefficient k of a batch: word j of point b at
  // base[(k * NW + j) * stride + b].  A lane moves its own W words of
  // each coefficient.  The T lanes of a group touch T rows of the batch,
  // and the 32 / T groups of a warp 32 / T neighbouring points of each:
  // whole 32-byte sectors for T = 4, half sectors for T = 8, whose other
  // half the next warp of the block takes.
  static __device__ __forceinline__ void el_load(const Ln& L, El& r,
                                                 const uint32_t* base, int k0,
                                                 long long stride,
                                                 long long b) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int w = 0; w < W; ++w)
        r.c[i].v[w] = base[((k0 + i) * NW + L.li * W + w) * stride + b];
  }
  static __device__ __forceinline__ void el_store(const Ln& L, const El& r,
                                                  uint32_t* base, int k0,
                                                  long long stride,
                                                  long long b) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int w = 0; w < W; ++w)
        base[((k0 + i) * NW + L.li * W + w) * stride + b] = r.c[i].v[w];
  }
  static __device__ __forceinline__ void pt_load(const Ln& L, Pt& R,
                                                 const uint32_t* base,
                                                 long long stride,
                                                 long long b) {
    el_load(L, R.X, base, 0, stride, b);
    el_load(L, R.Y, base, D, stride, b);
    el_load(L, R.Z, base, 2 * D, stride, b);
  }
  static __device__ __forceinline__ void pt_store(const Ln& L, const Pt& R,
                                                  uint32_t* base,
                                                  long long stride,
                                                  long long b) {
    el_store(L, R.X, base, 0, stride, b);
    el_store(L, R.Y, base, D, stride, b);
    el_store(L, R.Z, base, 2 * D, stride, b);
  }

  // -- RCB15 complete formulas (ops/ec.py CurveOps) ----------------------------------

  static __device__ __forceinline__ void ec_add(const Ln& L, Pt& R,
                                                const Pt& Pp, const Pt& Q) {
    El m1, m2, m3, m4, m5, m6, u, v, u2, v2, u3, v3, t3, t4, t5, t1d, t2c,
        X3, Z3c;
    mul3(L, m1, Pp.X, Q.X, m2, Pp.Y, Q.Y, m3, Pp.Z, Q.Z);
    add(L, u, Pp.X, Pp.Y);
    add(L, v, Q.X, Q.Y);
    add(L, u2, Pp.X, Pp.Z);
    add(L, v2, Q.X, Q.Z);
    add(L, u3, Pp.Y, Pp.Z);
    add(L, v3, Q.Y, Q.Z);
    mul3(L, m4, u, v, m5, u2, v2, m6, u3, v3);
    add(L, u, m1, m2);
    sub(L, t3, m4, u);
    add(L, u, m1, m3);
    sub(L, t4, m5, u);
    add(L, u, m2, m3);
    sub(L, t5, m6, u);
    mul_a(L, u, m3);            // a m3
    add(L, t1d, m1, m1);
    add(L, t1d, t1d, m1);
    add(L, t1d, t1d, u);        // 3 m1 + a m3
    sub(L, v, m1, u);
    mul_a(L, t2c, v);           // a (m1 - a m3)
    mul_b3_2(L, m4, m3, m5, t4);  // m7, m8
    mul_a(L, u, t4);            // t2a
    add(L, u, m4, u);           // Z3a = m7 + t2a
    sub(L, X3, m2, u);
    add(L, Z3c, m2, u);
    add(L, t2c, m5, t2c);       // t4c = m8 + t2c
    mul3(L, m1, X3, Z3c,        // m9
         m2, t1d, t2c,          // m10
         m3, t5, t2c);          // m11
    mul3(L, m4, X3, t3,         // m12
         m5, t3, t1d,           // m13
         m6, t5, Z3c);          // m14
    sub(L, R.X, m4, m3);
    add(L, R.Y, m1, m2);
    add(L, R.Z, m6, m5);
  }

  // Mixed addition with an affine (x2, y2); the caller handles an infinite
  // affine operand (ops/ec.py mixed_add's q_inf select).
  static __device__ __forceinline__ void ec_mixed_add(const Ln& L, Pt& R,
                                                      const Pt& Pp,
                                                      const El& x2,
                                                      const El& y2) {
    El m1, m2, m3, m4, m5, m6, u, v, t3, t4, t5, X3, Z3c, t1d, t2c;
    add(L, u, Pp.X, Pp.Y);
    add(L, v, x2, y2);
    mul3(L, m1, Pp.X, x2, m2, Pp.Y, y2, m3, u, v);
    mul2(L, m4, Pp.Z, x2, m5, Pp.Z, y2);
    add(L, u, m1, m2);
    sub(L, t3, m3, u);
    add(L, t4, m4, Pp.X);
    add(L, t5, m5, Pp.Y);
    mul_b3_2(L, m6, Pp.Z, m4, t4);  // m6, m8
    mul_a(L, u, t4);
    add(L, u, m6, u);           // Z3a
    sub(L, X3, m2, u);
    add(L, Z3c, m2, u);
    mul_a(L, v, Pp.Z);          // t2
    add(L, t1d, m1, m1);
    add(L, t1d, t1d, m1);
    add(L, t1d, t1d, v);
    sub(L, u, m1, v);
    mul_a(L, t2c, u);
    add(L, t2c, m4, t2c);       // t4c = m8 + t2c
    mul3(L, m3, X3, Z3c,        // m7
         m1, t1d, t2c,          // m9
         m2, t5, t2c);          // m10
    mul3(L, m4, X3, t3,         // m11
         m5, t3, t1d,           // m12
         m6, t5, Z3c);          // m13
    sub(L, R.X, m4, m2);
    add(L, R.Y, m3, m1);
    add(L, R.Z, m6, m5);
  }

  static __device__ __forceinline__ void ec_dbl(const Ln& L, Pt& R,
                                                const Pt& Pp) {
    El m1, m2, m3, m4, m5, m6, u, t3, z2, t3c, t0c, t2c, X3, Y3c;
    mul3(L, m1, Pp.X, Pp.X, m2, Pp.Y, Pp.Y, m3, Pp.Z, Pp.Z);
    mul3(L, m4, Pp.X, Pp.Y, m5, Pp.X, Pp.Z, m6, Pp.Y, Pp.Z);
    add(L, t3, m4, m4);
    add(L, z2, m5, m5);
    mul_a(L, u, m3);            // t2m
    sub(L, t3c, m1, u);
    mul_a(L, t3c, t3c);
    add(L, t0c, m1, m1);
    add(L, t0c, t0c, m1);
    add(L, t0c, t0c, u);
    add(L, t2c, m6, m6);
    mul_b3_2(L, m4, m3, m5, z2);  // m7, m8
    mul_a(L, u, z2);
    add(L, u, u, m4);           // Y3b
    sub(L, X3, m2, u);
    add(L, Y3c, m2, u);
    add(L, t3c, t3c, m5);       // t3d
    mul3(L, m1, X3, Y3c,        // m9
         m3, t3, X3,            // m10
         m4, t0c, t3c);         // m11
    mul2(L, m5, t2c, t3c,       // m12
         m6, t2c, m2);          // m13
    sub(L, R.X, m3, m5);
    add(L, R.Y, m1, m4);
    small<4>(L, R.Z, m6);
  }

  // -- XYZZ coordinates: the bucket scan's run accumulator (ops/ec.py
  // CurveOps.xyzz_*) ------------------------------------------------------------------
  // (X, Y, ZZ, ZZZ) stands for the affine point (X / ZZ, Y / ZZZ); ZZ = ZZZ
  // = 0 is the identity.  The scan's step (csrc/msm_scan.cu) adds an
  // affine row in 10 products.

  struct Pz {
    El X, Y, ZZ, ZZZ;
  };

  // R = (x, y, 1, 1), or the identity (1, 1, 0, 0) where `inf`
  static __device__ __forceinline__ void xyzz_lift(const Ln& L, Pz& R,
                                                   bool inf, const El& x,
                                                   const El& y) {
    El e1, e0;
    one(L, e1);
    zero(e0);
    select(R.X, inf, e1, x);
    select(R.Y, inf, e1, y);
    select(R.ZZ, inf, e0, e1);
    R.ZZZ = R.ZZ;
  }

  // R = (X ZZZ : Y ZZ : ZZ ZZZ), the identity as (0 : 1 : 0)
  static __device__ __forceinline__ void xyzz_to_proj(const Ln& L, Pt& R,
                                                      const Pz& A) {
    const bool inf = is_zero(L, A.ZZ);
    mul3(L, R.X, A.X, A.ZZZ, R.Y, A.Y, A.ZZ, R.Z, A.ZZ, A.ZZZ);
    Pt id;
    identity(L, id);
    select(R, inf, id, R);
  }
};

}  // namespace lanes
