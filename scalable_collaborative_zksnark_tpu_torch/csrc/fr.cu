// Elementwise field mul / add / sub for Hopper (sm_90a).
//
// Replaces fields/pallas_fr.py _mul_kernel, _add_kernel and _sub_kernel
// (one pallas_call site, _bin_call).  The TPU kernels transpose each tile
// to [L, M] so that 16-bit limbs sit on sublanes; that is a VPU layout and
// is not carried over.  Here one thread owns one element: it reads its
// 16-bit limbs as 16-byte vectors, packs limb pairs into 32-bit words and
// runs CIOS on 32x32->64 products (fr.cuh), a quarter of the partial
// products of the TPU's 16-bit schedule.
//
// Bound: in the port's storage (64 bytes per Fr element, 96 per Fq) every
// op moves 3 elements per result, so add and sub are bound by bytes, and
// mul too at these widths: 264 32-bit multiplies per Fr product at 16.7
// Tmul/s take less time than its 192 bytes at 3.35 TB/s.  Storing 32
// bytes per element would halve the bytes; that layout change is later
// work.
//
// Broadcasting: operand x is read at element (i % period_x), so a
// constant (period 1) or a repeated trailing block (a twiddle table) is
// not materialised.  The modulo is taken only for a trailing block: an
// operand of full size (period m) or a constant is indexed directly.
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

#include "fr.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned operand_index(unsigned i, unsigned period, unsigned m) {
  if (period == m) return i;
  if (period == 1) return 0;
  return i % period;
}

template <int N, int OP>
__global__ void binary_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, unsigned m, unsigned period_a,
                              unsigned period_b, FieldConst<N> f) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t x[N], y[N], r[N];
  load_limbs<N>(a + (size_t)operand_index(i, period_a, m) * (2 * N), x);
  load_limbs<N>(b + (size_t)operand_index(i, period_b, m) * (2 * N), y);
  if (OP == 0) {
    fmul<N>(r, x, y, f);
  } else if (OP == 1) {
    fadd<N>(r, x, y, f);
  } else {
    fsub<N>(r, x, y, f);
  }
  store_limbs<N>(out + (size_t)i * (2 * N), r);
}

template <int N>
cudaError_t launch(int op, const void* a, const void* b, void* out, unsigned m, unsigned pa,
                   unsigned pb, const uint32_t* consts, cudaStream_t s) {
  const FieldConst<N> f = field_const<N>(consts);
  const unsigned blocks = (m + kThreads - 1) / kThreads;
  auto A = static_cast<const int32_t*>(a);
  auto B = static_cast<const int32_t*>(b);
  auto O = static_cast<int32_t*>(out);
  if (op == 0) {
    binary_kernel<N, 0><<<blocks, kThreads, 0, s>>>(A, B, O, m, pa, pb, f);
  } else if (op == 1) {
    binary_kernel<N, 1><<<blocks, kThreads, 0, s>>>(A, B, O, m, pa, pb, f);
  } else {
    binary_kernel<N, 2><<<blocks, kThreads, 0, s>>>(A, B, O, m, pa, pb, f);
  }
  return cudaGetLastError();
}

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

// op: 0 mul, 1 add, 2 sub.  nwords: 8 (Fr) or 12 (Fq).  a, b, out: int32
// 16-bit limbs, [m, 2*nwords] for out; a and b are read at element
// (i % period).  consts: host array of nwords modulus words then n0.
extern "C" int sczk_fr_binary(int op, int nwords, const void* a, const void* b, void* out,
                              int m, int period_a, int period_b, const void* consts,
                              void* stream) {
  if (m <= 0 || period_a <= 0 || period_b <= 0 || op < 0 || op > 2) {
    return (int)cudaErrorInvalidValue;
  }
  auto c = static_cast<const uint32_t*>(consts);
  auto s = static_cast<cudaStream_t>(stream);
  if (nwords == 8) return (int)launch<8>(op, a, b, out, m, period_a, period_b, c, s);
  if (nwords == 12) return (int)launch<12>(op, a, b, out, m, period_a, period_b, c, s);
  return (int)cudaErrorInvalidValue;
}

// Registers and local (spill) bytes per thread of the kernel for op and
// nwords, as sczk_fr_binary takes them.  out: int32 [2].
extern "C" int sczk_fr_attrs(int op, int nwords, int* out) {
  const void* fns[2][3] = {
      {reinterpret_cast<const void*>(&binary_kernel<8, 0>),
       reinterpret_cast<const void*>(&binary_kernel<8, 1>),
       reinterpret_cast<const void*>(&binary_kernel<8, 2>)},
      {reinterpret_cast<const void*>(&binary_kernel<12, 0>),
       reinterpret_cast<const void*>(&binary_kernel<12, 1>),
       reinterpret_cast<const void*>(&binary_kernel<12, 2>)},
  };
  if (op < 0 || op > 2 || (nwords != 8 && nwords != 12)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[nwords == 12][op]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}
