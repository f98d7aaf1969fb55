// G1 group law for Hopper (sm_90a): y^2 = x^3 + b (a = 0) over the
// 381-bit base fields, in Jacobian coordinates (x = X/Z^2, y = Y/Z^3,
// Z = 0 is infinity), on the Fq word arithmetic of fr.cuh.
//
// The formulas are those of curves/pallas_g1.py (_double_t: dbl-2009-l;
// _add_t: add-2007-bl, and madd-2007-bl for an affine second operand),
// step by step in the same order.  Every field op returns a canonical
// value, so each output is bit-identical to the JAX package's Curve.add,
// add_mixed and double.  Where the TPU computes every case and selects
// per lane, a thread branches: infinity on either side returns the other
// operand, an x-collision doubles (equal points) or returns infinity
// (opposite points), and the doubling is computed only then.  Each output
// is the one the select would give.
//
// Cost in field products: mixed add 11, general add 16, double 7.  One
// point is 36 words; an add keeps about ten Fq temporaries live, so the
// kernels run few threads per SM and are bound by the latency of their
// dependent products (see g1.cu).
#pragma once

#include "fr.cuh"

constexpr int NQ = 12;  // words of a 381-bit base-field element

struct G1Const {
  FieldConst<NQ> f;
  uint32_t one[NQ];  // Montgomery 1 = R mod q, the y of infinity
};

// Host side: modulus words, n0, then the words of one, as the wrapper passes them.
inline G1Const g1_const(const uint32_t* host) {
  G1Const c;
  c.f = field_const<NQ>(host);
  for (int j = 0; j < NQ; ++j) c.one[j] = host[NQ + 1 + j];
  return c;
}

struct Pt {
  uint32_t x[NQ], y[NQ], z[NQ];
};

__device__ __forceinline__ bool fq_is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc |= a[j];
  return acc == 0;
}

__device__ __forceinline__ void fq_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < NQ; ++j) r[j] = a[j];
}

// Infinity as the JAX package writes it: (0, 1, 0).
__device__ __forceinline__ void set_infinity(Pt& p, const G1Const& c) {
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    p.x[j] = 0u;
    p.y[j] = c.one[j];
    p.z[j] = 0u;
  }
}

// dbl-2009-l; doubling infinity keeps Z = 0.  r may alias p.
__device__ __forceinline__ void g1_double(Pt& r, const Pt& p, const G1Const& c) {
  const FieldConst<NQ>& f = c.f;
  const bool inf = fq_is_zero(p.z);
  uint32_t A[NQ], B[NQ], C[NQ], t[NQ], D[NQ], E[NQ], X3[NQ], Y3[NQ], Z3[NQ];
  fmul<NQ>(A, p.x, p.x, f);
  fmul<NQ>(B, p.y, p.y, f);
  fmul<NQ>(C, B, B, f);
  fadd<NQ>(t, p.x, B, f);
  fmul<NQ>(t, t, t, f);
  fsub<NQ>(D, t, A, f);
  fsub<NQ>(D, D, C, f);
  fadd<NQ>(D, D, D, f);  // D = 2((X + B)^2 - A - C)
  fadd<NQ>(E, A, A, f);
  fadd<NQ>(E, E, A, f);  // E = 3A
  fmul<NQ>(X3, E, E, f);
  fadd<NQ>(t, D, D, f);
  fsub<NQ>(X3, X3, t, f);  // X3 = E^2 - 2D
  fadd<NQ>(C, C, C, f);
  fadd<NQ>(C, C, C, f);
  fadd<NQ>(C, C, C, f);  // 8C
  fsub<NQ>(t, D, X3, f);
  fmul<NQ>(Y3, E, t, f);
  fsub<NQ>(Y3, Y3, C, f);  // Y3 = E (D - X3) - 8C
  fmul<NQ>(Z3, p.y, p.z, f);
  fadd<NQ>(Z3, Z3, Z3, f);  // Z3 = 2 Y Z
  fq_copy(r.x, X3);
  fq_copy(r.y, Y3);
  if (inf) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) r.z[j] = 0u;
  } else {
    fq_copy(r.z, Z3);
  }
}

// p1 + p2, complete; MIXED takes p2 with Z2 in {0, 1} (affine or
// infinity).  Returns 1 when the sum was a doubling (an x-collision of
// equal points), else 0.  r may alias p1 or p2.
template <bool MIXED>
__device__ __forceinline__ int g1_add(Pt& r, const Pt& p1, const Pt& p2, const G1Const& c) {
  if (fq_is_zero(p1.z)) {
    r = p2;
    return 0;
  }
  if (fq_is_zero(p2.z)) {
    r = p1;
    return 0;
  }
  const FieldConst<NQ>& f = c.f;
  uint32_t Z1Z1[NQ], Z2Z2[NQ], U1[NQ], S1[NQ], U2[NQ], S2[NQ], H[NQ], R[NQ];
  fmul<NQ>(Z1Z1, p1.z, p1.z, f);
  if (MIXED) {
    fq_copy(U1, p1.x);
    fq_copy(S1, p1.y);
  } else {
    fmul<NQ>(Z2Z2, p2.z, p2.z, f);
    fmul<NQ>(U1, p1.x, Z2Z2, f);
    fmul<NQ>(S1, p1.y, p2.z, f);
    fmul<NQ>(S1, S1, Z2Z2, f);
  }
  fmul<NQ>(U2, p2.x, Z1Z1, f);
  fmul<NQ>(S2, p2.y, p1.z, f);
  fmul<NQ>(S2, S2, Z1Z1, f);
  fsub<NQ>(H, U2, U1, f);
  fsub<NQ>(R, S2, S1, f);
  if (fq_is_zero(H)) {
    if (fq_is_zero(R)) {
      g1_double(r, p1, c);
      return 1;
    }
    set_infinity(r, c);
    return 0;
  }
  uint32_t I[NQ], J[NQ], V[NQ], t[NQ], X3[NQ], Y3[NQ], Z3[NQ];
  fmul<NQ>(I, H, H, f);  // HH
  fadd<NQ>(I, I, I, f);
  fadd<NQ>(I, I, I, f);  // I = 4 HH
  fmul<NQ>(J, H, I, f);
  fadd<NQ>(R, R, R, f);  // r2 = 2r
  fmul<NQ>(V, U1, I, f);
  fmul<NQ>(X3, R, R, f);
  fsub<NQ>(X3, X3, J, f);
  fadd<NQ>(t, V, V, f);
  fsub<NQ>(X3, X3, t, f);  // X3 = r2^2 - J - 2V
  fsub<NQ>(t, V, X3, f);
  fmul<NQ>(Y3, R, t, f);
  fmul<NQ>(t, S1, J, f);
  fadd<NQ>(t, t, t, f);
  fsub<NQ>(Y3, Y3, t, f);  // Y3 = r2 (V - X3) - 2 S1 J
  if (MIXED) {
    fmul<NQ>(Z3, p1.z, H, f);
    fadd<NQ>(Z3, Z3, Z3, f);  // Z3 = 2 Z1 H
  } else {
    fadd<NQ>(t, p1.z, p2.z, f);
    fmul<NQ>(t, t, t, f);
    fsub<NQ>(t, t, Z1Z1, f);
    fsub<NQ>(t, t, Z2Z2, f);
    fmul<NQ>(Z3, t, H, f);  // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  }
  fq_copy(r.x, X3);
  fq_copy(r.y, Y3);
  fq_copy(r.z, Z3);
  return 0;
}
