// G1 point kernels for Hopper (sm_90a), on the group law of g1.cuh.
//
// Replaces curves/pallas_g1.py:
//   point_op_kernel      _add_kernel (add, add_mixed) and _double_kernel
//                        (_point_call): one thread per point;
//   masked_op_kernel     _add_masked_kernel and _add_reset_kernel (the same
//                        _point_call site): a mixed add under a per-lane
//                        mask, one thread per point;
//   accumulate_kernel    _add_reset_lazy_kernel with the lax.scan over
//                        steps around it and the repair of flagged lanes
//                        (primitives/msm.py _dense_bucket_sums);
//   scalar_mul_kernel    _scalar_mul_kernel: one thread per lane walks
//                        its MSB-first double-and-add ladder;
//   horner_kernel        _horner_kernel: sum_w 2^(c w) T_w, one thread per
//                        column;
//   bucket_serial_kernel _bucket_serial_kernel: sum_{k>=1} k B_k by the
//                        running suffix, one thread per (window, segment).
// The TPU's VMEM tiling (lane padding, the Horner budget split, the
// bucket-serial lane chunks, unroll and identity front-padding) is not
// carried over; the recurrences and their add order are.
//
// Bound: every kernel is a chain of dependent Fq products per thread
// (588 32-bit multiplies each, fr.cuh).  The point ops and the
// accumulate have enough lanes to be bound by integer-multiply
// throughput; Horner (C lanes, W (c + 1) dependent point ops),
// bucket-serial (2 (K - 2) dependent adds) and the scalar ladder are
// bound by the latency of their chain when they have few lanes: the
// dependent products times the depth of one CIOS product in dependent
// multiply-adds times one multiply-add's latency (imad_chain_kernel).
// One point is 288 bytes and each thread reads its own rows: in the
// accumulate kernel lane t's entries are `steps` apart, so its key and
// index loads do not coalesce, and its base loads are gathers (the base
// table is small enough to stay in L2).  That is accepted for now;
// writing only the bucket ends, coalescing the entry loads and fusing
// the cross-lane combine are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "g1.cuh"

namespace {

constexpr int kThreads = 64;  // few threads per block: spread lanes over the SMs
constexpr long long kSentinel = 0xFFFFFFFFll;  // key of padding entries

struct Coords {
  const int32_t* x;
  const int32_t* y;
  const int32_t* z;
};

struct OutCoords {
  int32_t* x;
  int32_t* y;
  int32_t* z;
};

__device__ __forceinline__ void load_point(const Coords& c, size_t i, Pt& p) {
  load_limbs<NQ>(c.x + i * (2 * NQ), p.x);
  load_limbs<NQ>(c.y + i * (2 * NQ), p.y);
  load_limbs<NQ>(c.z + i * (2 * NQ), p.z);
}

__device__ __forceinline__ void store_point(const OutCoords& c, size_t i, const Pt& p) {
  store_limbs<NQ>(c.x + i * (2 * NQ), p.x);
  store_limbs<NQ>(c.y + i * (2 * NQ), p.y);
  store_limbs<NQ>(c.z + i * (2 * NQ), p.z);
}

// OP: 0 add, 1 add_mixed, 2 double.
template <int OP>
__global__ void __launch_bounds__(kThreads)
    point_op_kernel(Coords a, Coords b, OutCoords out, unsigned m, G1Const c) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Pt p, r;
  load_point(a, i, p);
  if (OP == 2) {
    g1_double(r, p, c);
  } else {
    Pt q;
    load_point(b, i, q);
    g1_add<OP == 1>(r, p, q, c);
  }
  store_point(out, i, r);
}

// OP: 0 add_masked (out = mask ? a + b : a, the bucket accumulate step of
// the non-dense MSM cores), 1 add_reset (out = mask ? a + b : b); b is
// affine or infinity (mixed add).  A lane whose mask is 0 does no
// arithmetic: it copies its operand, as the TPU's select would return it.
template <int OP>
__global__ void __launch_bounds__(kThreads)
    masked_op_kernel(Coords a, Coords b, const uint8_t* __restrict__ mask, OutCoords out,
                     unsigned m, G1Const c) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Pt p;
  if (mask[i]) {
    Pt q;
    load_point(a, i, p);
    load_point(b, i, q);
    g1_add<true>(p, p, q, c);
  } else {
    load_point(OP == 0 ? a : b, i, p);
  }
  store_point(out, i, p);
}

// Lane t walks entries [t steps, (t + 1) steps) of the key-sorted list:
// acc = (key == previous key) ? acc + P : P, with P = bases[pid], negated
// where neg is set; scanned[s, t] = acc after step s.  Entries past E are
// padding: key kSentinel, P = infinity.  The x-collision case doubles in
// the thread; `repaired` counts those steps.
__global__ void __launch_bounds__(kThreads)
    accumulate_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ pid,
                      const uint8_t* __restrict__ neg, long long E, Coords bases, unsigned T,
                      unsigned steps, OutCoords scanned, int* repaired, G1Const c) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  uint32_t zero[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) zero[j] = 0u;
  Pt acc, p;
  set_infinity(acc, c);
  long long prev = kSentinel;
  int rep = 0;
  for (unsigned s = 0; s < steps; ++s) {
    const long long e = (long long)t * steps + s;
    long long k;
    if (e < E) {
      k = keys[e];
      load_point(bases, (size_t)pid[e], p);
      if (neg[e]) fsub<NQ>(p.y, zero, p.y, c.f);
    } else {
      k = kSentinel;
      set_infinity(p, c);
    }
    if (k == prev) {
      rep += g1_add<true>(acc, acc, p, c);
    } else {
      acc = p;
    }
    prev = k;
    store_point(scanned, (size_t)s * T + t, acc);
  }
  if (rep) atomicAdd(repaired, rep);
}

// scalars: n_limbs 16-bit limbs per lane, standard form, least significant first.
__global__ void __launch_bounds__(kThreads)
    scalar_mul_kernel(Coords pts, const int32_t* __restrict__ scalars, int n_limbs, unsigned m,
                      OutCoords out, G1Const c) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Pt P, acc;
  load_point(pts, i, P);
  set_infinity(acc, c);
  const int32_t* sc = scalars + (size_t)i * n_limbs;
  for (int l = n_limbs - 1; l >= 0; --l) {
    const uint32_t w = (uint32_t)sc[l];
    for (int b = 15; b >= 0; --b) {
      g1_double(acc, acc, c);
      if ((w >> b) & 1u) g1_add<false>(acc, acc, P, c);
    }
  }
  store_point(out, i, acc);
}

// tot: [W, C] window totals, window 0 least significant.
__global__ void __launch_bounds__(kThreads)
    horner_kernel(Coords tot, unsigned W, unsigned C, int cbits, OutCoords out, G1Const c) {
  const unsigned col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C) return;
  Pt acc, T;
  set_infinity(acc, c);
  for (int w = (int)W - 1; w >= 0; --w) {
    for (int j = 0; j < cbits; ++j) g1_double(acc, acc, c);
    load_point(tot, (size_t)w * C + col, T);
    g1_add<false>(acc, acc, T, c);
  }
  store_point(out, col, acc);
}

// buckets: [K, M], bucket k ascending; out[m] = sum_{k>=1} k B_k.
__global__ void __launch_bounds__(kThreads)
    bucket_serial_kernel(Coords buckets, unsigned K, unsigned M, OutCoords out, G1Const c) {
  const unsigned lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= M) return;
  Pt acc, tot, B;
  load_point(buckets, (size_t)(K - 1) * M + lane, acc);
  tot = acc;
  for (int k = (int)K - 2; k >= 1; --k) {
    load_point(buckets, (size_t)k * M + lane, B);
    g1_add<false>(acc, acc, B, c);
    g1_add<false>(tot, tot, acc, c);
  }
  store_point(out, lane, tot);
}

// One thread runs n dependent 32x32->64 multiply-adds, c = lo(c) * y + c
// mod 2^64 (one IMAD.WIDE.U32 each): the kernel's time over n is the
// latency of one dependent step of a CIOS product on the card, the unit
// of the chain bounds of the latency-bound kernels above.  A probe for
// that bound; it replaces no TPU kernel.
__global__ void imad_chain_kernel(const uint32_t* a, int n, uint64_t* out) {
  uint64_t c = a[0];
  const uint32_t y = a[1];
  for (int i = 0; i < n; ++i) c = (uint64_t)(uint32_t)c * y + c;
  *out = c;
}

// One thread multiplies x by y n times, each product depending on the
// last: the time over n is what one Fq product of fr.cuh costs in a
// single thread.  A diagnostic beside the chain bound; it replaces no
// TPU kernel.
__global__ void fq_mul_chain_kernel(const int32_t* a, int n, int32_t* out, FieldConst<NQ> f) {
  uint32_t x[NQ], y[NQ];
  load_limbs<NQ>(a, x);
  load_limbs<NQ>(a + 2 * NQ, y);
  for (int i = 0; i < n; ++i) fmul<NQ>(x, x, y, f);
  store_limbs<NQ>(out, x);
}

unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

Coords coords(const void* x, const void* y, const void* z) {
  return {static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
          static_cast<const int32_t*>(z)};
}

OutCoords out_coords(void* x, void* y, void* z) {
  return {static_cast<int32_t*>(x), static_cast<int32_t*>(y), static_cast<int32_t*>(z)};
}

G1Const consts_of(const void* consts) { return g1_const(static_cast<const uint32_t*>(consts)); }

}  // namespace

// Every coordinate is int32 [n, 24] (16-bit limbs, Montgomery form),
// contiguous and 16-byte aligned.  consts: 12 modulus words, n0, then 12
// words of Montgomery 1.  Each entry returns the launch's cudaError_t.

// op: 0 add, 1 add_mixed, 2 double (b unused).  m points.
extern "C" int sczk_g1_point_op(int op, const void* ax, const void* ay, const void* az,
                                const void* bx, const void* by, const void* bz, void* ox, void* oy,
                                void* oz, int m, const void* consts, void* stream) {
  if (m <= 0 || op < 0 || op > 2) return (int)cudaErrorInvalidValue;
  const Coords a = coords(ax, ay, az), b = coords(bx, by, bz);
  const OutCoords o = out_coords(ox, oy, oz);
  const G1Const c = consts_of(consts);
  auto s = static_cast<cudaStream_t>(stream);
  if (op == 0) {
    point_op_kernel<0><<<blocks(m), kThreads, 0, s>>>(a, b, o, (unsigned)m, c);
  } else if (op == 1) {
    point_op_kernel<1><<<blocks(m), kThreads, 0, s>>>(a, b, o, (unsigned)m, c);
  } else {
    point_op_kernel<2><<<blocks(m), kThreads, 0, s>>>(a, b, o, (unsigned)m, c);
  }
  return (int)cudaGetLastError();
}

// op: 0 add_masked, 1 add_reset; mask: uint8 [m] (0 or 1); b affine or
// infinity.  m points.
extern "C" int sczk_g1_masked_op(int op, const void* ax, const void* ay, const void* az,
                                 const void* bx, const void* by, const void* bz,
                                 const void* mask, void* ox, void* oy, void* oz, int m,
                                 const void* consts, void* stream) {
  if (m <= 0 || op < 0 || op > 1) return (int)cudaErrorInvalidValue;
  const Coords a = coords(ax, ay, az), b = coords(bx, by, bz);
  const OutCoords o = out_coords(ox, oy, oz);
  const auto* mk = static_cast<const uint8_t*>(mask);
  const G1Const c = consts_of(consts);
  auto s = static_cast<cudaStream_t>(stream);
  if (op == 0) {
    masked_op_kernel<0><<<blocks(m), kThreads, 0, s>>>(a, b, mk, o, (unsigned)m, c);
  } else {
    masked_op_kernel<1><<<blocks(m), kThreads, 0, s>>>(a, b, mk, o, (unsigned)m, c);
  }
  return (int)cudaGetLastError();
}

// keys, pid: int64 [E]; neg: uint8 [E]; bases: the point table pid
// indexes; scanned: [steps, T]; repaired: one int32, incremented.
extern "C" int sczk_g1_accumulate(const void* keys, const void* pid, const void* neg, long long E,
                                  const void* bx, const void* by, const void* bz, int T, int steps,
                                  void* sx, void* sy, void* sz, void* repaired, const void* consts,
                                  void* stream) {
  if (T <= 0 || steps <= 0 || E < 0 || E > (long long)T * steps) return (int)cudaErrorInvalidValue;
  accumulate_kernel<<<blocks(T), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(pid),
      static_cast<const uint8_t*>(neg), E, coords(bx, by, bz), (unsigned)T, (unsigned)steps,
      out_coords(sx, sy, sz), static_cast<int*>(repaired), consts_of(consts));
  return (int)cudaGetLastError();
}

// scalars: int32 [m, n_limbs] standard-form 16-bit limbs.
extern "C" int sczk_g1_scalar_mul(const void* px, const void* py, const void* pz,
                                  const void* scalars, int n_limbs, int m, void* ox, void* oy,
                                  void* oz, const void* consts, void* stream) {
  if (m <= 0 || n_limbs <= 0) return (int)cudaErrorInvalidValue;
  scalar_mul_kernel<<<blocks(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coords(px, py, pz), static_cast<const int32_t*>(scalars), n_limbs, (unsigned)m,
      out_coords(ox, oy, oz), consts_of(consts));
  return (int)cudaGetLastError();
}

// tot: [W, C]; out: [C]; c: doublings per window.
extern "C" int sczk_g1_horner(const void* tx, const void* ty, const void* tz, int W, int C, int c,
                              void* ox, void* oy, void* oz, const void* consts, void* stream) {
  if (W <= 0 || C <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  horner_kernel<<<blocks(C), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coords(tx, ty, tz), (unsigned)W, (unsigned)C, c, out_coords(ox, oy, oz), consts_of(consts));
  return (int)cudaGetLastError();
}

// buckets: [K, M] with K >= 2; out: [M].
extern "C" int sczk_g1_bucket_serial(const void* bx, const void* by, const void* bz, int K, int M,
                                     void* ox, void* oy, void* oz, const void* consts,
                                     void* stream) {
  if (K < 2 || M <= 0) return (int)cudaErrorInvalidValue;
  bucket_serial_kernel<<<blocks(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coords(bx, by, bz), (unsigned)K, (unsigned)M, out_coords(ox, oy, oz), consts_of(consts));
  return (int)cudaGetLastError();
}

// a: int32 [2, 24] (x, y); out: int32 [24] = x y^n R^-n.
extern "C" int sczk_fq_mul_chain(const void* a, int n, void* out, const void* consts,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  fq_mul_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), n, static_cast<int32_t*>(out), consts_of(consts).f);
  return (int)cudaGetLastError();
}

// a: uint32 [2] (x, y); out: uint64 [1], the chain's c after n steps.
extern "C" int sczk_imad_chain(const void* a, int n, void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  imad_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), n, static_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread of kernel `which`:
// 0 add, 1 add_mixed, 2 double, 3 accumulate, 4 scalar_mul, 5 horner,
// 6 bucket_serial, 7 add_masked, 8 add_reset.  out: int32 [2].
extern "C" int sczk_g1_attrs(int which, int* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(&point_op_kernel<0>),
      reinterpret_cast<const void*>(&point_op_kernel<1>),
      reinterpret_cast<const void*>(&point_op_kernel<2>),
      reinterpret_cast<const void*>(&accumulate_kernel),
      reinterpret_cast<const void*>(&scalar_mul_kernel),
      reinterpret_cast<const void*>(&horner_kernel),
      reinterpret_cast<const void*>(&bucket_serial_kernel),
      reinterpret_cast<const void*>(&masked_op_kernel<0>),
      reinterpret_cast<const void*>(&masked_op_kernel<1>),
  };
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}
