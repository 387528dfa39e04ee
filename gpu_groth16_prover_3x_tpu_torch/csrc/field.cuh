// Device field and group layer shared by the kernels: 753-bit Montgomery
// arithmetic over 24 x 32-bit words (R = 2^768, the file format's radix),
// the Fq2 / Fq3 towers, and the complete projective group law of
// Renes-Costello-Batina 2016 (EPRINT 2015/1060, Algorithms 1-3, general a)
// exactly as the plain PyTorch version (ops/ec.py) writes it.  Every value
// is canonical (< p) on entry and exit of every function here, so a
// kernel and its plain version agree word for word.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "g16_constants.cuh"  // G16_P, G16_NINV, G16_ONE, G16_B3 (generated)

#define NW 24

struct Fp {
  uint32_t v[NW];
};

// -- prime field --------------------------------------------------------------

// CIOS Montgomery product a*b/R mod p with 64-bit accumulators; canonical
// output by one conditional subtract ((ab + mp)/R < 2p for a, b < p).
template <int P>
__device__ __forceinline__ void fp_mul_inl(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t ai = a.v[i];
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)ai * b.v[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * G16_NINV[P];
    s = (uint64_t)m * G16_P[P][0] + t[0];
    c = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * G16_P[P][j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  uint32_t d[NW];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - G16_P[P][j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 32) & 1u;
  }
  const bool ge = (t[NW] != 0) || (br == 0);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = ge ? d[j] : t[j];
}

// Out-of-line copy for the group formulas: one body per prime instead of
// ~80 inlined products per group op keeps nvcc's compile time in seconds.
template <int P>
__device__ __noinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  fp_mul_inl<P>(r, a, b);
}

template <int P>
__device__ __forceinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW], d[NW];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.v[j] + b.v[j] + c;
    t[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - G16_P[P][j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 32) & 1u;
  }
  const bool ge = (c != 0) || (br == 0);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = ge ? d[j] : t[j];
}

template <int P>
__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t d[NW];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.v[j] - b.v[j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 32) & 1u;
  }
  // borrow: a < b, add p back
  const uint32_t msk = 0u - br;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)d[j] + (G16_P[P][j] & msk) + c;
    r.v[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

// k * a mod p for a small compile-time k, by a double-and-add chain.
template <int P, int K>
__device__ __forceinline__ void fp_small(Fp& r, const Fp& a) {
  if constexpr (K == 1) {
    r = a;
  } else {
    Fp h;
    fp_small<P, K / 2>(h, a);
    fp_add<P>(h, h, h);
    if constexpr (K & 1) fp_add<P>(h, h, a);
    r = h;
  }
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) acc |= a.v[j];
  return acc == 0;
}

template <int P>
__device__ __forceinline__ void fp_one(Fp& r) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = G16_ONE[P][j];
}

__device__ __forceinline__ void fp_zero(Fp& r) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = 0;
}

// -- extension tower Fq^D = Fq[v]/(v^D - AL), D in {1, 2, 3} --------------------

template <int P, int D, int AL>
struct Ext {
  Fp c[D];
};

// Coefficient-wise add / sub / small multiple.  For the towers (D > 1)
// these and the product below are out of line: one body per field keeps
// the deg-2 and deg-3 group formulas small enough for nvcc to compile in
// seconds instead of minutes.
template <int P, int D, int AL>
__device__ __noinline__ void e_add_ext(Ext<P, D, AL>& r,
                                       const Ext<P, D, AL>& a,
                                       const Ext<P, D, AL>& b) {
#pragma unroll
  for (int i = 0; i < D; ++i) fp_add<P>(r.c[i], a.c[i], b.c[i]);
}

template <int P, int D, int AL>
__device__ __noinline__ void e_sub_ext(Ext<P, D, AL>& r,
                                       const Ext<P, D, AL>& a,
                                       const Ext<P, D, AL>& b) {
#pragma unroll
  for (int i = 0; i < D; ++i) fp_sub<P>(r.c[i], a.c[i], b.c[i]);
}

template <int K, int P, int D, int AL>
__device__ __noinline__ void e_small_ext(Ext<P, D, AL>& r,
                                         const Ext<P, D, AL>& a) {
#pragma unroll
  for (int i = 0; i < D; ++i) fp_small<P, K>(r.c[i], a.c[i]);
}

// Karatsuba with the non-residue folded in (ops/field.py mul_many).
// Every input is read before r is written, so r may alias a or b.
template <int P, int D, int AL>
__device__ __noinline__ void e_mul_ext(Ext<P, D, AL>& r,
                                       const Ext<P, D, AL>& a,
                                       const Ext<P, D, AL>& b) {
  if constexpr (D == 2) {
    Fp t0, t1, t2, s0, s1;
    fp_mul<P>(t0, a.c[0], b.c[0]);
    fp_mul<P>(t1, a.c[1], b.c[1]);
    fp_add<P>(s0, a.c[0], a.c[1]);
    fp_add<P>(s1, b.c[0], b.c[1]);
    fp_mul<P>(t2, s0, s1);
    fp_small<P, AL>(s0, t1);
    fp_add<P>(r.c[0], t0, s0);
    fp_add<P>(s1, t0, t1);
    fp_sub<P>(r.c[1], t2, s1);
  } else {
    Fp t0, t1, t2, u01, u02, u12, x, y;
    fp_mul<P>(t0, a.c[0], b.c[0]);
    fp_mul<P>(t1, a.c[1], b.c[1]);
    fp_mul<P>(t2, a.c[2], b.c[2]);
    fp_add<P>(x, a.c[0], a.c[1]);
    fp_add<P>(y, b.c[0], b.c[1]);
    fp_mul<P>(u01, x, y);
    fp_add<P>(x, a.c[0], a.c[2]);
    fp_add<P>(y, b.c[0], b.c[2]);
    fp_mul<P>(u02, x, y);
    fp_add<P>(x, a.c[1], a.c[2]);
    fp_add<P>(y, b.c[1], b.c[2]);
    fp_mul<P>(u12, x, y);
    // s01 = u01 - (t0 + t1), s02 = u02 - (t0 + t2), s12 = u12 - (t1 + t2)
    fp_add<P>(x, t0, t1);
    fp_sub<P>(u01, u01, x);
    fp_add<P>(x, t0, t2);
    fp_sub<P>(u02, u02, x);
    fp_add<P>(x, t1, t2);
    fp_sub<P>(u12, u12, x);
    fp_small<P, AL>(x, u12);
    fp_add<P>(r.c[0], t0, x);
    fp_small<P, AL>(x, t2);
    fp_add<P>(r.c[1], u01, x);
    fp_add<P>(r.c[2], u02, t1);
  }
}

template <int P, int D, int AL>
__device__ __forceinline__ void e_add(Ext<P, D, AL>& r, const Ext<P, D, AL>& a,
                                      const Ext<P, D, AL>& b) {
  if constexpr (D == 1) fp_add<P>(r.c[0], a.c[0], b.c[0]);
  else e_add_ext(r, a, b);
}

template <int P, int D, int AL>
__device__ __forceinline__ void e_sub(Ext<P, D, AL>& r, const Ext<P, D, AL>& a,
                                      const Ext<P, D, AL>& b) {
  if constexpr (D == 1) fp_sub<P>(r.c[0], a.c[0], b.c[0]);
  else e_sub_ext(r, a, b);
}

template <int K, int P, int D, int AL>
__device__ __forceinline__ void e_small(Ext<P, D, AL>& r,
                                        const Ext<P, D, AL>& a) {
  if constexpr (D == 1) fp_small<P, K>(r.c[0], a.c[0]);
  else e_small_ext<K>(r, a);
}

template <int P, int D, int AL>
__device__ __forceinline__ void e_mul(Ext<P, D, AL>& r, const Ext<P, D, AL>& a,
                                      const Ext<P, D, AL>& b) {
  if constexpr (D == 1) fp_mul<P>(r.c[0], a.c[0], b.c[0]);
  else e_mul_ext(r, a, b);
}

// -- group configurations -------------------------------------------------------
// CFG 0: MNT4753 G1 over Fq = P_B; a = 2.
// CFG 1: MNT4753 G2 over Fq2 (alpha 13); a = (26, 0), b3 = (0, c).
// CFG 2: MNT6753 G1 over Fq = P_A; a = 11.
// CFG 3: MNT6753 G2 over Fq3 (alpha 11); a = (0, 0, 11), b3 = (c, 0, 0).

template <int CFG>
struct Cfg;

template <>
struct Cfg<0> {
  static constexpr int P = 1, D = 1, AL = 13;
  using El = Ext<P, D, AL>;
  static __device__ __forceinline__ void mul_a(El& r, const El& t) {
    e_small<2>(r, t);
  }
  static __device__ __forceinline__ void mul_b3(El& r, const El& t) {
    Fp c;
#pragma unroll
    for (int j = 0; j < NW; ++j) c.v[j] = G16_B3[0][j];
    fp_mul<P>(r.c[0], c, t.c[0]);
  }
};

template <>
struct Cfg<1> {
  static constexpr int P = 1, D = 2, AL = 13;
  using El = Ext<P, D, AL>;
  static __device__ __forceinline__ void mul_a(El& r, const El& t) {
    e_small<26>(r, t);
  }
  // (c v) * (t0 + t1 v) = alpha c t1 + c t0 v
  static __device__ __noinline__ void mul_b3(El& r, const El& t) {
    Fp c, u0, u1;
#pragma unroll
    for (int j = 0; j < NW; ++j) c.v[j] = G16_B3[1][j];
    fp_mul<P>(u0, c, t.c[0]);
    fp_mul<P>(u1, c, t.c[1]);
    fp_small<P, AL>(r.c[0], u1);
    r.c[1] = u0;
  }
};

template <>
struct Cfg<2> {
  static constexpr int P = 0, D = 1, AL = 11;
  using El = Ext<P, D, AL>;
  static __device__ __forceinline__ void mul_a(El& r, const El& t) {
    e_small<11>(r, t);
  }
  static __device__ __forceinline__ void mul_b3(El& r, const El& t) {
    Fp c;
#pragma unroll
    for (int j = 0; j < NW; ++j) c.v[j] = G16_B3[2][j];
    fp_mul<P>(r.c[0], c, t.c[0]);
  }
};

template <>
struct Cfg<3> {
  static constexpr int P = 0, D = 3, AL = 11;
  using El = Ext<P, D, AL>;
  // (11 v^2) * (t0 + t1 v + t2 v^2) = 121 t1 + 121 t2 v + 11 t0 v^2
  static __device__ __noinline__ void mul_a(El& r, const El& t) {
    Fp u0, u1, u2;
    fp_small<P, 121>(u0, t.c[1]);
    fp_small<P, 121>(u1, t.c[2]);
    fp_small<P, 11>(u2, t.c[0]);
    r.c[0] = u0;
    r.c[1] = u1;
    r.c[2] = u2;
  }
  static __device__ __noinline__ void mul_b3(El& r, const El& t) {
    Fp c;
#pragma unroll
    for (int j = 0; j < NW; ++j) c.v[j] = G16_B3[3][j];
#pragma unroll
    for (int i = 0; i < D; ++i) fp_mul<P>(r.c[i], c, t.c[i]);
  }
};

// -- points ------------------------------------------------------------------------

template <int CFG>
struct Pt {
  typename Cfg<CFG>::El X, Y, Z;
};

template <int CFG>
__device__ __forceinline__ void pt_identity(Pt<CFG>& R) {
  constexpr int D = Cfg<CFG>::D, P = Cfg<CFG>::P;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    fp_zero(R.X.c[i]);
    fp_zero(R.Y.c[i]);
    fp_zero(R.Z.c[i]);
  }
  fp_one<P>(R.Y.c[0]);
}

// Coordinate block k of a point batch: word j of lane b at
// base[(k * NW + j) * stride + b]; k runs over X coeffs, Y coeffs, Z coeffs.
template <int CFG>
__device__ __forceinline__ void pt_load(Pt<CFG>& R, const uint32_t* base,
                                        long long stride, long long b) {
  constexpr int D = Cfg<CFG>::D;
  typename Cfg<CFG>::El* co[3] = {&R.X, &R.Y, &R.Z};
#pragma unroll
  for (int k = 0; k < 3 * D; ++k)
#pragma unroll
    for (int j = 0; j < NW; ++j)
      co[k / D]->c[k % D].v[j] = base[(k * NW + j) * stride + b];
}

template <int CFG>
__device__ __forceinline__ void pt_store(const Pt<CFG>& R, uint32_t* base,
                                         long long stride, long long b) {
  constexpr int D = Cfg<CFG>::D;
  const typename Cfg<CFG>::El* co[3] = {&R.X, &R.Y, &R.Z};
#pragma unroll
  for (int k = 0; k < 3 * D; ++k)
#pragma unroll
    for (int j = 0; j < NW; ++j)
      base[(k * NW + j) * stride + b] = co[k / D]->c[k % D].v[j];
}

// -- RCB15 complete formulas (ops/ec.py CurveOps) ----------------------------------

template <int CFG>
__device__ void ec_add(Pt<CFG>& R, const Pt<CFG>& Pp, const Pt<CFG>& Q) {
  using C = Cfg<CFG>;
  using El = typename C::El;
  El m1, m2, m3, m4, m5, m6, u, v, t3, t4, t5, t1d, t2c, X3, Z3c;
  e_mul(m1, Pp.X, Q.X);
  e_mul(m2, Pp.Y, Q.Y);
  e_mul(m3, Pp.Z, Q.Z);
  e_add(u, Pp.X, Pp.Y);
  e_add(v, Q.X, Q.Y);
  e_mul(m4, u, v);
  e_add(u, Pp.X, Pp.Z);
  e_add(v, Q.X, Q.Z);
  e_mul(m5, u, v);
  e_add(u, Pp.Y, Pp.Z);
  e_add(v, Q.Y, Q.Z);
  e_mul(m6, u, v);
  e_add(u, m1, m2);
  e_sub(t3, m4, u);
  e_add(u, m1, m3);
  e_sub(t4, m5, u);
  e_add(u, m2, m3);
  e_sub(t5, m6, u);
  C::mul_a(u, m3);          // a m3
  e_add(t1d, m1, m1);
  e_add(t1d, t1d, m1);
  e_add(t1d, t1d, u);       // 3 m1 + a m3
  e_sub(v, m1, u);
  C::mul_a(t2c, v);         // a (m1 - a m3)
  C::mul_b3(m4, m3);        // m7
  C::mul_a(u, t4);          // t2a
  e_add(u, m4, u);          // Z3a = m7 + t2a
  e_sub(X3, m2, u);
  e_add(Z3c, m2, u);
  C::mul_b3(m5, t4);        // m8
  e_add(t2c, m5, t2c);      // t4c = m8 + t2c
  e_mul(m1, X3, Z3c);       // m9
  e_mul(m2, t1d, t2c);      // m10
  e_mul(m3, t5, t2c);       // m11
  e_mul(m4, X3, t3);        // m12
  e_mul(m5, t3, t1d);       // m13
  e_mul(m6, t5, Z3c);       // m14
  e_sub(R.X, m4, m3);
  e_add(R.Y, m1, m2);
  e_add(R.Z, m6, m5);
}

// Mixed addition with an affine (x2, y2); the caller handles an infinite
// affine operand (ops/ec.py mixed_add's q_inf select).
template <int CFG>
__device__ void ec_mixed_add(Pt<CFG>& R, const Pt<CFG>& Pp,
                             const typename Cfg<CFG>::El& x2,
                             const typename Cfg<CFG>::El& y2) {
  using C = Cfg<CFG>;
  using El = typename C::El;
  El m1, m2, m3, m4, m5, m6, u, v, t3, t4, t5, X3, Z3c, t1d, t2c;
  e_mul(m1, Pp.X, x2);
  e_mul(m2, Pp.Y, y2);
  e_add(u, Pp.X, Pp.Y);
  e_add(v, x2, y2);
  e_mul(m3, u, v);
  e_mul(m4, Pp.Z, x2);
  e_mul(m5, Pp.Z, y2);
  C::mul_b3(m6, Pp.Z);
  e_add(u, m1, m2);
  e_sub(t3, m3, u);
  e_add(t4, m4, Pp.X);
  e_add(t5, m5, Pp.Y);
  C::mul_a(u, t4);
  e_add(u, m6, u);          // Z3a
  e_sub(X3, m2, u);
  e_add(Z3c, m2, u);
  C::mul_a(v, Pp.Z);        // t2
  e_add(t1d, m1, m1);
  e_add(t1d, t1d, m1);
  e_add(t1d, t1d, v);
  e_sub(u, m1, v);
  C::mul_a(t2c, u);
  e_mul(m3, X3, Z3c);       // m7
  C::mul_b3(m4, t4);        // m8
  e_add(t2c, m4, t2c);      // t4c
  e_mul(m1, t1d, t2c);      // m9
  e_mul(m2, t5, t2c);       // m10
  e_mul(m4, X3, t3);        // m11
  e_mul(m5, t3, t1d);       // m12
  e_mul(m6, t5, Z3c);       // m13
  e_sub(R.X, m4, m2);
  e_add(R.Y, m3, m1);
  e_add(R.Z, m6, m5);
}

template <int CFG>
__device__ void ec_dbl(Pt<CFG>& R, const Pt<CFG>& Pp) {
  using C = Cfg<CFG>;
  using El = typename C::El;
  El m1, m2, m3, m4, m5, m6, u, t3, z2, t3c, t0c, t2c, X3, Y3c;
  e_mul(m1, Pp.X, Pp.X);
  e_mul(m2, Pp.Y, Pp.Y);
  e_mul(m3, Pp.Z, Pp.Z);
  e_mul(m4, Pp.X, Pp.Y);
  e_mul(m5, Pp.X, Pp.Z);
  e_mul(m6, Pp.Y, Pp.Z);
  e_add(t3, m4, m4);
  e_add(z2, m5, m5);
  C::mul_a(u, m3);          // t2m
  e_sub(t3c, m1, u);
  C::mul_a(t3c, t3c);
  e_add(t0c, m1, m1);
  e_add(t0c, t0c, m1);
  e_add(t0c, t0c, u);
  e_add(t2c, m6, m6);
  C::mul_b3(m4, m3);        // m7
  C::mul_b3(m5, z2);        // m8
  C::mul_a(u, z2);
  e_add(u, u, m4);          // Y3b
  e_sub(X3, m2, u);
  e_add(Y3c, m2, u);
  e_add(t3c, t3c, m5);      // t3d
  e_mul(m1, X3, Y3c);       // m9
  e_mul(m3, t3, X3);        // m10
  e_mul(m4, t0c, t3c);      // m11
  e_mul(m5, t2c, t3c);      // m12
  e_mul(m6, t2c, m2);       // m13
  e_sub(R.X, m3, m5);
  e_add(R.Y, m1, m4);
  e_small<4>(R.Z, m6);
}
