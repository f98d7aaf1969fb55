// Elementwise field mul / add / sub for Hopper (sm_90a).
//
// Replaces fields/pallas_fr.py _mul_kernel, _add_kernel and _sub_kernel
// (one pallas_call site, _bin_call).  The TPU kernels transpose each tile
// to [L, M] so that 16-bit limbs sit on sublanes; that is a VPU layout and
// is not carried over.  Here one thread owns one element: it packs its
// 16-bit limbs into 32-bit words and runs the carry-chain arithmetic of
// fq_chain.cuh (mont_mul_cc<N>, add_mod_cc<N>, sub_mod_cc<N>: canonical
// and bit-equal to fr.cuh's fmul, fadd and fsub).
//
// What bounds it.  In the port's storage (64 bytes per Fr element, 96 per
// Fq) every op moves 3 elements a result, so at large shapes add, sub
// and mul are all bound by bytes (2^20 Fr products: 0.0601 ms at 3.35
// TB/s against 0.0165 ms of 32-bit multiplies).  The prove's calls are
// tiny instead (its commonest Fr product is one element), where a launch
// costs the latency of one thread's chain: one Fr product is 38 dependent
// multiply-adds (cios_depth), about 0.43 us on mont_mul_cc<8> against
// 0.83 us on fmul<8> (a one-thread chain on an H100), and the launch
// itself.
//
// What the design does about it.
// * Operands are read in place.  The wrapper (fields/cuda_fr.py
//   kernel_operands) coalesces the output's batch dims as PyTorch's
//   TensorIterator does and passes, for each operand, its base and its
//   int32-slot stride along each coalesced dim (0 where it broadcasts), up
//   to kRank dims: transposed views, stepped slices and broadcasts in any
//   dim are not copied, and neither is an operand whose base is not
//   16-byte aligned.  The C entry marks, per operand, whether its base and
//   strides allow 16-byte vector loads.
// * Small launches (fewer than the wrapper's STAGE_MIN outputs, both
//   operands taking 16-byte loads) run one thread an element, kThreads a
//   block, straight from the operands, with that load width fixed at
//   compile time.  Every other launch runs the staged instance, which
//   reads an operand at the width its flag gives; no call of the (16, 8)
//   prove has an operand without 16-byte loads.  At the prove's shapes a
//   small launch is 0.3-0.4 us faster than a staged one (1 to 64 outputs);
//   from 256 outputs the staged one is as fast or faster (PERF.md §6).
// * Large launches stage.  Loading an element's 64 or 96 bytes as 16-byte
//   vectors from one thread makes each warp instruction touch 32
//   elements' sectors at a 64- or 96-byte pitch, half or a third of each
//   sector used.  A staged block of kStageThreads threads instead copies
//   each dense operand's tile (kStageThreads consecutive elements) into
//   shared memory with coalesced loads (thread t takes 16-byte chunk t,
//   t + kStageThreads, ...: each warp instruction reads 512 contiguous
//   bytes), each thread then reads its element from shared memory, and
//   the results go back the same way, staged in shared memory and stored
//   as contiguous chunks.  Chunk k of element e sits at slot swizzle(e, k)
//   of the tile, so that the eight threads of each quarter warp meet eight
//   different bank groups both when they stage chunks and when they read
//   their elements' chunks.  An operand that is not dense (broadcast,
//   strided) is read straight from device memory by its thread.
//
// The same Fr product in the limb-major layouts of the JAX package's
// scripts/exp_fieldmul.py, replacing its mont_kernel_lm (int32 [16, m],
// m a multiple of 1,024) and mont_kernel_lm2 (tiled [m/4096, 16, 8, 512]:
// limb j of tile g at g*16*4096 + j*4096 + (i mod 4096)).  One thread per
// element, 256 a block, reads limb j at base + j*stride, so each warp-wide
// load of a limb row is 128 contiguous bytes; it packs the 16 limbs into 8
// words and runs fmul<8>.  The TPU's (8, 512) vreg tiles and its 16-bit
// partial-product schedule are not carried over.  Bound: the same bytes as
// the element-major mul, 3 x 64 B per product (2^20 products: 0.0601 ms at
// 3.35 TB/s), against 264 32-bit multiplies per product (0.0165 ms at
// 16.73 T/s): bytes.  The experiment is whether the layout, whose loads are
// 4-byte coalesced rows instead of 16-byte vectors of one element, closes
// the element-major kernel's distance to that bound.
#include <cuda_runtime.h>

#include <cstdint>

#include "fq_chain.cuh"

namespace {

constexpr int kThreads = 256;       // threads a block of the strided products and of a small launch
constexpr int kStageThreads = 128;  // threads, and elements of a tile, a block of a staged launch
constexpr int kRank = 4;            // coalesced batch dims a launch takes (cuda_fr.MAX_RANK)

// Where element i of the output reads one operand.
struct Operand {
  const int32_t* base;
  long long stride[kRank];  // int32 slots a step along each coalesced dim; 0 broadcasts
  int vec;                  // base and strides allow 16-byte loads
  int dense;                // element i at base + 2N i: a staged launch stages it
};

// The output's coalesced batch dims, outermost first.
struct Dims {
  int rank;
  unsigned n[kRank];
};

// Slots of operands a and b for output element i.
__device__ __forceinline__ void offsets(const Dims& d, unsigned i, const Operand& a,
                                        const Operand& b, size_t& oa, size_t& ob) {
  oa = ob = 0;
#pragma unroll
  for (int k = kRank - 1; k >= 0; --k) {
    if (k < d.rank) {
      const unsigned q = k ? i / d.n[k] : 0u, c = i - q * d.n[k];
      oa += (size_t)c * (size_t)a.stride[k];
      ob += (size_t)c * (size_t)b.stride[k];
      i = q;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_any(const int32_t* src, int vec, uint32_t* w) {
  if (vec) {
    load_limbs<N>(src, w);
  } else {
    load_limbs_strided<N>(src, 1, w);
  }
}

template <int N, int OP>
__device__ __forceinline__ void apply(uint32_t* r, const uint32_t* x, const uint32_t* y,
                                      const FieldConst<N>& f) {
  if (OP == 0) {
    fqcc::mont_mul_cc<N>(r, x, y, f);
  } else if (OP == 1) {
    fqcc::add_mod_cc<N>(r, x, y, f);
  } else {
    fqcc::sub_mod_cc<N>(r, x, y, f);
  }
}

// Slot of 16-byte chunk k of element e in a staged tile (N / 2 chunks an
// element).  Fr: e's chunks stay in e's four slots, permuted by bits 1-2
// of e, so the eight elements of a quarter warp's reads cover the eight
// 16-byte bank groups; Fq: six slots, permuted by bit 2 of e.  Either way
// eight consecutive chunks, as a quarter warp stages them, fill eight
// consecutive slots.
template <int N>
__device__ __forceinline__ unsigned swizzle(unsigned e, unsigned k) {
  static_assert(N == 8 || N == 12, "staged tiles hold Fr (8 words) or Fq (12) elements");
  return N == 8 ? e * 4u + (k ^ ((e >> 1) & 3u)) : e * 6u + (k ^ ((e >> 2) & 1u));
}

// Operand x's elements [i0, i0 + n) into `tile`, coalesced: 16-byte
// chunks where x.vec, else 4-byte slots.
template <int N>
__device__ __forceinline__ void stage(int4* tile, const Operand& x, unsigned i0, unsigned n) {
  constexpr unsigned C = N / 2, L = 2 * N;
  const int32_t* src = x.base + (size_t)i0 * L;
  if (x.vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (unsigned j = 0; j < C; ++j) {
      const unsigned g = threadIdx.x + j * kStageThreads;
      if (g < n * C) tile[swizzle<N>(g / C, g % C)] = s4[g];
    }
  } else {
    int32_t* t = reinterpret_cast<int32_t*>(tile);
#pragma unroll
    for (unsigned j = 0; j < L; ++j) {
      const unsigned g = threadIdx.x + j * kStageThreads;
      if (g < n * L) t[4 * swizzle<N>(g / L, g % L / 4) + g % 4] = src[g];
    }
  }
}

template <int N>
__device__ __forceinline__ void read_tile(const int4* tile, unsigned e, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const int4 v = tile[swizzle<N>(e, k)];
    w[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    w[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
}

template <int N>
__device__ __forceinline__ void write_tile(int4* tile, unsigned e, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    int4 v;
    v.x = (int32_t)(w[2 * k] & 0xFFFFu);
    v.y = (int32_t)(w[2 * k] >> 16);
    v.z = (int32_t)(w[2 * k + 1] & 0xFFFFu);
    v.w = (int32_t)(w[2 * k + 1] >> 16);
    tile[swizzle<N>(e, k)] = v;
  }
}

// The staged launch's block: kStageThreads consecutive outputs, dense
// operands and the results through shared memory.
template <int N, int OP>
__device__ __forceinline__ void staged_body(const Operand& a, const Operand& b,
                                            int32_t* __restrict__ out, const Dims& d,
                                            unsigned m, const FieldConst<N>& f) {
  constexpr unsigned C = N / 2;
  __shared__ int4 tiles[2][kStageThreads * C];  // a's (then the results), b's
  const unsigned i0 = blockIdx.x * kStageThreads, e = threadIdx.x;
  const unsigned n = min((unsigned)kStageThreads, m - i0);
  if (a.dense) stage<N>(tiles[0], a, i0, n);
  if (b.dense) stage<N>(tiles[1], b, i0, n);
  __syncthreads();
  if (e < n) {
    uint32_t x[N], y[N], r[N];
    size_t oa, ob;
    offsets(d, i0 + e, a, b, oa, ob);
    if (a.dense) {
      read_tile<N>(tiles[0], e, x);
    } else {
      load_any<N>(a.base + oa, a.vec, x);
    }
    if (b.dense) {
      read_tile<N>(tiles[1], e, y);
    } else {
      load_any<N>(b.base + ob, b.vec, y);
    }
    apply<N, OP>(r, x, y, f);
    write_tile<N>(tiles[0], e, r);  // the slots this thread alone read
  }
  __syncthreads();
  int4* o4 = reinterpret_cast<int4*>(out + (size_t)i0 * (2 * N));
#pragma unroll
  for (unsigned j = 0; j < C; ++j) {
    const unsigned g = threadIdx.x + j * kStageThreads;
    if (g < n * C) o4[g] = tiles[0][swizzle<N>(g / C, g % C)];
  }
}

// out[i] = a[i] OP b[i] (OP 0 mul, 1 add, 2 sub), one thread an element.
// STAGED: a block owns kStageThreads consecutive outputs and stages its
// dense operands and its results through shared memory.  A small launch
// reads each element straight from its operands with 16-byte loads, the
// width fixed at compile time: choosing it at run time cost a one-element
// product about 0.19 us of device time on an H100.
template <int N, int OP, bool STAGED>
__global__ void __launch_bounds__(STAGED ? kStageThreads : kThreads)
    binary_kernel(Operand a, Operand b, int32_t* __restrict__ out, Dims d, unsigned m,
                  FieldConst<N> f) {
  if constexpr (STAGED) {
    staged_body<N, OP>(a, b, out, d, m, f);
  } else {
    const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    uint32_t x[N], y[N], r[N];
    size_t oa, ob;
    offsets(d, i, a, b, oa, ob);
    load_limbs<N>(a.base + oa, x);
    load_limbs<N>(b.base + ob, y);
    apply<N, OP>(r, x, y, f);
    store_limbs<N>(out + (size_t)i * (2 * N), r);
  }
}

// Host side: an operand of N-word elements from its base and strides.
template <int N>
Operand operand(const void* base, const long long* stride, const Dims& d) {
  Operand x{static_cast<const int32_t*>(base), {}, reinterpret_cast<uintptr_t>(base) % 16 == 0,
            1};
  long long dense = 2 * N;  // the stride of a dense operand along dim k
  for (int k = d.rank - 1; k >= 0; --k) {
    x.stride[k] = stride[k];
    if (d.n[k] > 1 && stride[k] % 4) x.vec = 0;
    if (d.n[k] > 1 && stride[k] != dense) x.dense = 0;
    dense *= d.n[k];
  }
  return x;
}

template <int N, int OP, bool STAGED>
void launch_one(const Operand& a, const Operand& b, int32_t* out, const Dims& d, unsigned m,
                const FieldConst<N>& f, cudaStream_t s) {
  const unsigned threads = STAGED ? kStageThreads : kThreads;
  binary_kernel<N, OP, STAGED><<<(m + threads - 1) / threads, threads, 0, s>>>(a, b, out, d, m,
                                                                                f);
}

template <int N, int OP>
void launch_op(bool staged, const Operand& a, const Operand& b, int32_t* out, const Dims& d,
               unsigned m, const FieldConst<N>& f, cudaStream_t s) {
  if (staged) {
    launch_one<N, OP, true>(a, b, out, d, m, f, s);
  } else {
    launch_one<N, OP, false>(a, b, out, d, m, f, s);
  }
}

template <int N>
cudaError_t launch(int op, const void* pa, const void* pb, void* out, const Dims& d, unsigned m,
                   const long long* strides, bool staged, const uint32_t* consts,
                   cudaStream_t s) {
  const FieldConst<N> f = field_const<N>(consts);
  const Operand a = operand<N>(pa, strides, d), b = operand<N>(pb, strides + d.rank, d);
  auto O = static_cast<int32_t*>(out);
  const bool stage = staged || !(a.vec && b.vec);
  if (op == 0) launch_op<N, 0>(stage, a, b, O, d, m, f, s);
  if (op == 1) launch_op<N, 1>(stage, a, b, O, d, m, f, s);
  if (op == 2) launch_op<N, 2>(stage, a, b, O, d, m, f, s);
  return cudaGetLastError();
}

// Does nothing: one launch of it on the card is the device time that
// every launch costs, the floor of the prove's small elementwise calls.  A
// probe; it replaces no TPU kernel.
__global__ void empty_kernel() {}

constexpr unsigned kTile = 4096;  // elements of one tile of the tiled layout

// LAYOUT 0: [16, m] limb-major; 1: [m / kTile, 16, 8, 512] tiled.
template <int LAYOUT>
__global__ void mul_strided_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                   int32_t* __restrict__ out, unsigned m, FieldConst<8> f) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const size_t base = LAYOUT == 0 ? (size_t)i : (size_t)(i / kTile) * 16 * kTile + i % kTile;
  const size_t stride = LAYOUT == 0 ? (size_t)m : (size_t)kTile;
  uint32_t x[8], y[8], r[8];
  load_limbs_strided<8>(a + base, stride, x);
  load_limbs_strided<8>(b + base, stride, y);
  fmul<8>(r, x, y, f);
  store_limbs_strided<8>(out + base, stride, r);
}

}  // namespace

// layout: 0 limb-major int32 [16, m] (m a multiple of 1,024), 1 tiled
// [m / 4096, 16, 8, 512] (m a multiple of 4,096); Fr only.  consts: host
// array of the 8 modulus words then n0.
extern "C" int sczk_fr_mul_strided(int layout, const void* a, const void* b, void* out, int m,
                                   const void* consts, void* stream) {
  if (m <= 0 || (layout == 0 && m % 1024) || (layout == 1 && m % (int)kTile) || layout < 0 ||
      layout > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const FieldConst<8> f = field_const<8>(static_cast<const uint32_t*>(consts));
  const unsigned blocks = ((unsigned)m + kThreads - 1) / kThreads;
  auto A = static_cast<const int32_t*>(a);
  auto B = static_cast<const int32_t*>(b);
  auto O = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (layout == 0) {
    mul_strided_kernel<0><<<blocks, kThreads, 0, s>>>(A, B, O, (unsigned)m, f);
  } else {
    mul_strided_kernel<1><<<blocks, kThreads, 0, s>>>(A, B, O, (unsigned)m, f);
  }
  return (int)cudaGetLastError();
}

// One launch of empty_kernel (one warp).
extern "C" int sczk_fr_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread of the strided kernel for
// layout.  out: int32 [2].
extern "C" int sczk_fr_strided_attrs(int layout, int* out) {
  if (layout < 0 || layout > 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, layout == 0 ? reinterpret_cast<const void*>(&mul_strided_kernel<0>)
                      : reinterpret_cast<const void*>(&mul_strided_kernel<1>));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}

// op: 0 mul, 1 add, 2 sub.  nwords: 8 (Fr) or 12 (Fq).  out: contiguous
// int32 [m, 2 nwords] 16-bit limbs, 16-byte aligned, m the product of the
// rank (1 .. 4) coalesced batch dims.  layout: host int64 [3 rank], the
// dims (outermost first), then a's strides, then b's: operand x's element
// at coordinates c is read at x + sum_k c_k stride_k int32 slots (each
// stride >= 0), its 2 nwords limbs contiguous.  staged: stage dense
// operands and the results through shared memory (a launch with an
// operand that does not take 16-byte loads stages whatever it says).  consts: host array of
// nwords modulus words then n0.
extern "C" int sczk_fr_binary(int op, int nwords, const void* a, const void* b, void* out,
                              int rank, const void* layout, int staged, const void* consts,
                              void* stream) {
  if (op < 0 || op > 2 || rank < 1 || rank > kRank || reinterpret_cast<uintptr_t>(out) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  Dims d{rank, {}};
  unsigned long long m = 1;
  auto n = static_cast<const long long*>(layout);
  auto st = n + rank;
  for (int k = 0; k < rank; ++k) {
    if (n[k] <= 0) return (int)cudaErrorInvalidValue;
    d.n[k] = (unsigned)n[k];
    m *= (unsigned long long)n[k];
  }
  for (int k = 0; k < 2 * rank; ++k) {
    if (st[k] < 0) return (int)cudaErrorInvalidValue;
  }
  if (m >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  auto c = static_cast<const uint32_t*>(consts);
  auto s = static_cast<cudaStream_t>(stream);
  if (nwords == 8) return (int)launch<8>(op, a, b, out, d, (unsigned)m, st, staged, c, s);
  if (nwords == 12) return (int)launch<12>(op, a, b, out, d, (unsigned)m, st, staged, c, s);
  return (int)cudaErrorInvalidValue;
}

// Registers and local (spill) bytes per thread of the kernel for op,
// nwords and staged (0 a small launch, 1 a staged one).  out: int32 [2].
extern "C" int sczk_fr_attrs(int op, int nwords, int staged, int* out) {
#define SCZK_FR_OPS(N, STAGED)                                         \
  {reinterpret_cast<const void*>(&binary_kernel<N, 0, STAGED>),        \
   reinterpret_cast<const void*>(&binary_kernel<N, 1, STAGED>),        \
   reinterpret_cast<const void*>(&binary_kernel<N, 2, STAGED>)}
  const void* fns[2][2][3] = {
      {SCZK_FR_OPS(8, false), SCZK_FR_OPS(8, true)},
      {SCZK_FR_OPS(12, false), SCZK_FR_OPS(12, true)},
  };
#undef SCZK_FR_OPS
  if (op < 0 || op > 2 || staged < 0 || staged > 1 || (nwords != 8 && nwords != 12)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[nwords == 12][staged][op]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}
