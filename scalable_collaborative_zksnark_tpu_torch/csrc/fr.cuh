// Prime-field arithmetic on 32-bit words for Hopper (sm_90a).
//
// An element is N little-endian 32-bit words in Montgomery form with
// R = 2^(32N): N = 8 for the BLS12 scalar fields (Fr), 12 for the base
// fields (Fq).  In device memory the port stores elements as 2N int32
// slots holding 16-bit limbs (the JAX package's layout); word k is
// limb[2k] | limb[2k+1] << 16, and R = 2^(16 * 2N) is the same radix, so
// values need no re-encoding between the two layouts.
//
// All functions take canonical inputs (< p) and return canonical outputs.
// Used by the elementwise kernels (fr.cu) and the sumcheck phase
// (sumcheck.cu); the G1 point kernels will use them too.
#pragma once

#include <cstdint>

template <int N>
struct FieldConst {
  uint32_t p[N];  // modulus words
  uint32_t n0;    // -p^{-1} mod 2^32
};

// Host side: modulus words then n0, as the Python wrapper passes them.
template <int N>
inline FieldConst<N> field_const(const uint32_t* host) {
  FieldConst<N> f;
  for (int j = 0; j < N; ++j) f.p[j] = host[j];
  f.n0 = host[N];
  return f;
}

// 2N int32 16-bit limbs -> N words (16-byte vector loads; the element
// stride, 64 or 96 bytes, keeps every element 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_limbs(const int32_t* src, uint32_t* w) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    int4 v = s4[k];
    w[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    w[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
}

template <int N>
__device__ __forceinline__ void store_limbs(int32_t* dst, const uint32_t* w) {
  int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    int4 v;
    v.x = (int32_t)(w[2 * k] & 0xFFFFu);
    v.y = (int32_t)(w[2 * k] >> 16);
    v.z = (int32_t)(w[2 * k + 1] & 0xFFFFu);
    v.w = (int32_t)(w[2 * k + 1] >> 16);
    d4[k] = v;
  }
}

// 2N 16-bit limbs spaced `stride` int32 slots apart (limb-major layouts:
// neighbouring threads read neighbouring slots of each limb row).
template <int N>
__device__ __forceinline__ void load_limbs_strided(const int32_t* src, size_t stride,
                                                   uint32_t* w) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    w[k] = (uint32_t)src[(2 * k) * stride] | ((uint32_t)src[(2 * k + 1) * stride] << 16);
  }
}

template <int N>
__device__ __forceinline__ void store_limbs_strided(int32_t* dst, size_t stride,
                                                    const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    dst[(2 * k) * stride] = (int32_t)(w[k] & 0xFFFFu);
    dst[(2 * k + 1) * stride] = (int32_t)(w[k] >> 16);
  }
}

// N packed words (the sumcheck's intermediate tables, 32 bytes per Fr).
template <int N>
__device__ __forceinline__ void load_words(const uint32_t* src, uint32_t* w) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    uint4 v = s4[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t* w) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) d4[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// r = t - p if (hi != 0 or t >= p) else t, for a value t + hi * 2^(32N) < 2p.
template <int N>
__device__ __forceinline__ void reduce_once(uint32_t* r, const uint32_t* t, uint32_t hi,
                                            const FieldConst<N>& f) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)t[j] - f.p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = take ? d[j] : t[j];
}

// r = a + b mod p
template <int N>
__device__ __forceinline__ void fadd(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                     const FieldConst<N>& f) {
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<N>(r, s, (uint32_t)c, f);
}

// r = a - b mod p
template <int N>
__device__ __forceinline__ void fsub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                     const FieldConst<N>& f) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back when a < b
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)d[j] + (f.p[j] & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// r = a * b * 2^(-32N) mod p: CIOS Montgomery multiplication with 64-bit
// accumulators (each step a 32x32->64 multiply-add, which cannot
// overflow: (2^32-1)^2 + 2(2^32-1) = 2^64-1).  The running value stays
// below 2p, so one conditional subtract makes it canonical.
template <int N>
__device__ __forceinline__ void fmul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                     const FieldConst<N>& f) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * f.n0;
    c = ((uint64_t)m * f.p[0] + t[0]) >> 32;  // low word is 0 by choice of m
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c += (uint64_t)m * f.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  reduce_once<N>(r, t, t[N], f);
}
