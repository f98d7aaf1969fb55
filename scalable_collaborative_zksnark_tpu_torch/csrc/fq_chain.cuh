// A low-latency Montgomery product on 32-bit words, for the chain-bound
// kernels: the 381-bit base field (N = 12, fq_mul_cc) of g1_chain.cu and
// g1_team.cuh, and the 255-bit scalar field (N = 8, fr_mul_cc) of the
// sumcheck fold phase (sumcheck.cu), with the phase's modular add and
// subtract on the same carry flag (fr_add_cc, fr_sub_cc; at the end).
//
// fmul (fr.cuh) runs CIOS with one 64-bit carry variable: every
// multiply-add of a row waits for the previous one's carry, and the
// 64-bit adds around each 32x32->64 product add instructions to that
// chain.  Here each row is split by the parity of the operand word, as
// in the even/odd CIOS of Emmart, Zheng and Weems (and sppark's mont_t):
// the products a[j] b_i with even j land on words (j, j + 1) of one
// accumulator and those with odd j on the other, so the pairs of one
// accumulator never overlap and each is one chain of mad.lo.cc /
// madc.hi.cc with the carry in the flag (ptxas fuses each such pair into
// one 64-bit IMAD.WIDE with carry).  The two accumulators' chains are
// independent, so the scheduler can overlap them.  After a row's reduction
// the accumulators swap roles, which is the one-word shift of CIOS; rows
// therefore go in pairs, and N must be even.
//
// With a, b < p < 2^(32N - 1) (Fq: p < 2^382, Fr: r < 2^255), every
// partial sum stays below 2p 2^32 < 2^(32(N + 1)), so the accumulators
// never carry out of their N words (see the notes at each step); the
// result before the final subtract is below 2p.  It is the canonical
// Montgomery product a b 2^(-32N) mod p, bit-equal to fmul<N>.
#pragma once

#include <cstdint>

#include "fr.cuh"

namespace fqcc {

// ---- carry-flag primitives (PTX); the carry flag crosses statements,
// so nothing else may run between the statements of one chain ----
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("mul.hi.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t d;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// ---- end of primitives ----

// acc[j], acc[j + 1] = a[j] * bi for even j (a read at even offsets).
template <int N>
__device__ __forceinline__ void mul_even(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = mul_lo(a[j], bi);
    acc[j + 1] = mul_hi(a[j], bi);
  }
}

// acc += sum over even j of a[j] bi 2^(32 j), one carry chain; leaves
// the carry out of acc[N - 1] in the flag.
template <int N>
__device__ __forceinline__ void cmad_even(uint32_t* acc, const uint32_t* a, uint32_t bi) {
  acc[0] = mad_lo_cc(a[0], bi, acc[0]);
  acc[1] = madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = madc_lo_cc(a[j], bi, acc[j]);
    acc[j + 1] = madc_hi_cc(a[j], bi, acc[j + 1]);
  }
}

// acc = (acc >> 64) + sum over even j of a[j] bi 2^(32 j) + flag: the
// shifted accumulator and the row's products in one chain, taking the
// carry in the flag; the top word cannot carry out.
template <int N>
__device__ __forceinline__ void madc_even_rshift(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    acc[j] = madc_lo_cc(a[j], bi, acc[j + 2]);
    acc[j + 1] = madc_hi_cc(a[j], bi, acc[j + 3]);
  }
  acc[N - 2] = madc_lo_cc(a[N - 2], bi, 0u);
  acc[N - 1] = madc_hi(a[N - 2], bi, 0u);
}

// One row: on entry `even` holds the running value's words 0 .. N - 1
// (word 0 still to take odd[1]) and `odd` the words that the last
// reduction left one word up (odd[k] belongs to word k - 1 after the
// shift; odd[0] is the zero word that the reduction made); adds a b_i,
// then m p with m = even[0] n0, which zeroes word 0.  On return the
// value is even + odd 2^32 with even[0] = 0: the caller swaps the roles
// of the two arrays, which divides by 2^32.
template <int N>
__device__ __forceinline__ void mad_row_redc(uint32_t* even, uint32_t* odd, const uint32_t* a,
                                             uint32_t bi, const FieldConst<N>& f, bool first) {
  if (first) {
    mul_even<N>(odd, a + 1, bi);
    mul_even<N>(even, a, bi);
  } else {
    even[0] = add_cc(even[0], odd[1]);
    madc_even_rshift<N>(odd, a + 1, bi);
    cmad_even<N>(even, a, bi);
    odd[N - 1] = addc(odd[N - 1], 0u);
  }
  const uint32_t m = even[0] * f.n0;
  cmad_even<N>(odd, f.p + 1, m);  // no carry out: odd 2^32 stays below 2^(32(N + 1))
  cmad_even<N>(even, f.p, m);
  odd[N - 1] = addc(odd[N - 1], 0u);
}

// r = a b 2^(-32N) mod p for canonical a, b (N words each); r may alias
// a or b.
template <int N>
__device__ __forceinline__ void mont_mul_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                            const FieldConst<N>& f) {
  static_assert(N % 2 == 0, "rows go in pairs");
  uint32_t even[N], odd[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mad_row_redc<N>(even, odd, a, b[i], f, i == 0);
    mad_row_redc<N>(odd, even, a, b[i + 1], f, false);
  }
  // merge: value = odd (word 0 zero) + even 2^32, then the last shift
  even[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) even[j] = addc_cc(even[j], odd[j + 1]);
  even[N - 1] = addc(even[N - 1], 0u);
  // canonical: subtract p once if even >= p (even < 2p)
  uint32_t d[N];
  d[0] = sub_cc(even[0], f.p[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(even[j], f.p[j]);
  const uint32_t borrow = subc(0u, 0u);  // 0xFFFFFFFF if even < p
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = borrow ? even[j] : d[j];
}

// r = a + b mod p for canonical a, b: one carry chain for the sum, one
// borrow chain for the sum less p, the sum kept where that borrows.
template <int N>
__device__ __forceinline__ void add_mod_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                           const FieldConst<N>& f) {
  uint32_t s[N], d[N];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) s[j] = addc_cc(a[j], b[j]);
  const uint32_t carry = addc(0u, 0u);
  d[0] = sub_cc(s[0], f.p[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(s[j], f.p[j]);
  const uint32_t borrow = subc(carry, 0u);  // 0xFFFFFFFF iff carry:s < p
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = borrow == 0xFFFFFFFFu ? s[j] : d[j];
}

// r = a - b mod p for canonical a, b: one borrow chain, then p added back
// in one carry chain where it borrowed.
template <int N>
__device__ __forceinline__ void sub_mod_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                           const FieldConst<N>& f) {
  uint32_t d[N], q[N];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0u, 0u);  // 0xFFFFFFFF iff a < b
#pragma unroll
  for (int j = 0; j < N; ++j) q[j] = f.p[j] & mask;
  r[0] = add_cc(d[0], q[0]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) r[j] = addc_cc(d[j], q[j]);
  r[N - 1] = addc(d[N - 1], q[N - 1]);
}

}  // namespace fqcc

// r = a b 2^-384 mod p on the base field (12 words), canonical a, b.
__device__ __forceinline__ void fq_mul_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                          const FieldConst<12>& f) {
  fqcc::mont_mul_cc<12>(r, a, b, f);
}

// r = a b 2^-256 mod r on the scalar field (8 words), canonical a, b.
__device__ __forceinline__ void fr_mul_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                          const FieldConst<8>& f) {
  fqcc::mont_mul_cc<8>(r, a, b, f);
}

// r = a + b and a - b mod r on the scalar field (8 words), canonical a, b,
// on the carry flag (the sumcheck phase's linear steps).
__device__ __forceinline__ void fr_add_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                          const FieldConst<8>& f) {
  fqcc::add_mod_cc<8>(r, a, b, f);
}

__device__ __forceinline__ void fr_sub_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                          const FieldConst<8>& f) {
  fqcc::sub_mod_cc<8>(r, a, b, f);
}
