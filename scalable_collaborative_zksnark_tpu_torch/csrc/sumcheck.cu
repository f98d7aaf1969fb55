// Sumcheck product fold phase for Hopper (sm_90a).
//
// Replaces primitives/pallas_sumcheck.py _phase_kernel (via product_phase).
// For a batch of B table pairs f, g of M = 2^R evaluations it computes,
// for every round r, the messages
//   t0 = sum lo_f*lo_g,  t1 = sum hi_f*hi_g,  t2 = sum (2hi_f-lo_f)(2hi_g-lo_g)
// as canonical field elements, and folds both tables to lo + c_r (hi - lo).
//
// Why the design differs from the TPU kernel: that kernel keeps both
// tables resident in VMEM for all rounds.  In the port's storage (64 bytes
// per Fr element) one slot's pair at the gate-identity shape (M = 2^13) is
// 1 MiB and at the reference's envelope (M = 2^25) 4 GiB, against 227 KB
// of shared memory per block.  So each round is one launch over the B*M/2
// pairs: a thread loads lo and hi of f and g, forms the three products,
// writes the folded f', g' to the next (half-size) table, and the block
// reduces its three partial sums with field adds (warp shuffles, then
// shared memory).  A second small launch adds the per-block partials of
// each slot into the round's message.  The first round reads the 16-bit
// limb layout, later rounds read and write packed 32-bit words (32 bytes
// per element), and the last round writes the folded finals as limbs.
// The TPU kernel's u32 column sums, its M <= 2^16 limit and its lane-roll
// tail rounds are TPU artefacts and are not carried over: messages leave
// canonical and every M >= 2 runs in one call.
//
// Bound: 5 Montgomery products per pair and round (t0, t1, t2 and the two
// folds), 1,320 32-bit multiplies per pair against 128 bytes read in the
// first round, so the phase is bound by integer multiply throughput.
// Keeping all tables at 32 bytes per element from the start, more pairs
// per thread and fusing the rounds once a slot fits one block are later
// work.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

constexpr int N = 8;          // Fr: 8 words
constexpr int kThreads = 256;  // threads per block; the wrapper sizes partials with it

__device__ __forceinline__ void warp_reduce(uint32_t* v, const FieldConst<N>& f) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    uint32_t o[N];
#pragma unroll
    for (int w = 0; w < N; ++w) o[w] = __shfl_down_sync(0xffffffffu, v[w], off);
    fadd<N>(v, v, o, f);
  }
}

// Field sum of s[k] over the block; thread 0 ends with the totals.
__device__ __forceinline__ void block_reduce3(uint32_t (&s)[3][N], const FieldConst<N>& f) {
  __shared__ uint32_t sh[kThreads / 32][3][N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) warp_reduce(s[k], f);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int w = 0; w < N; ++w) sh[warp][k][w] = s[k][w];
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int w = 0; w < N; ++w) s[k][w] = lane < nw ? sh[lane][k][w] : 0u;
#pragma unroll
    for (int k = 0; k < 3; ++k) warp_reduce(s[k], f);
  }
}

__device__ __forceinline__ void load_elem(const void* base, size_t idx, int limbs, uint32_t* w) {
  if (limbs) {
    load_limbs<N>(static_cast<const int32_t*>(base) + idx * (2 * N), w);
  } else {
    load_words<N>(static_cast<const uint32_t*>(base) + idx * N, w);
  }
}

__device__ __forceinline__ void store_elem(void* base, size_t idx, int limbs, const uint32_t* w) {
  if (limbs) {
    store_limbs<N>(static_cast<int32_t*>(base) + idx * (2 * N), w);
  } else {
    store_words<N>(static_cast<uint32_t*>(base) + idx * N, w);
  }
}

// grid (nblk, B): one round over the pairs (j, j + half) of slot blockIdx.y.
__global__ void __launch_bounds__(kThreads)
    product_round_kernel(const void* f_in, const void* g_in, int in_limbs, void* f_out,
                         void* g_out, int out_limbs, uint32_t* partial,
                         const int32_t* ch, unsigned half, FieldConst<N> fc) {
  const unsigned b = blockIdx.y;
  const unsigned j = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t s[3][N];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int w = 0; w < N; ++w) s[k][w] = 0u;
  if (j < half) {
    uint32_t lf[N], hf[N], lg[N], hg[N], c[N], df[N], dg[N], ef[N], eg[N];
    const size_t lo = (size_t)b * (2 * (size_t)half) + j;
    load_elem(f_in, lo, in_limbs, lf);
    load_elem(f_in, lo + half, in_limbs, hf);
    load_elem(g_in, lo, in_limbs, lg);
    load_elem(g_in, lo + half, in_limbs, hg);
    load_limbs<N>(ch, c);
    fmul<N>(s[0], lf, lg, fc);
    fmul<N>(s[1], hf, hg, fc);
    fsub<N>(df, hf, lf, fc);
    fsub<N>(dg, hg, lg, fc);
    fadd<N>(ef, hf, df, fc);  // 2 hi - lo = hi + (hi - lo)
    fadd<N>(eg, hg, dg, fc);
    fmul<N>(s[2], ef, eg, fc);
    fmul<N>(df, c, df, fc);  // lo + c (hi - lo)
    fadd<N>(df, lf, df, fc);
    fmul<N>(dg, c, dg, fc);
    fadd<N>(dg, lg, dg, fc);
    const size_t o = (size_t)b * half + j;
    store_elem(f_out, o, out_limbs, df);
    store_elem(g_out, o, out_limbs, dg);
  }
  block_reduce3(s, fc);
  if (threadIdx.x == 0) {
    uint32_t* out = partial + ((size_t)b * gridDim.x + blockIdx.x) * (3 * N);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int w = 0; w < N; ++w) out[k * N + w] = s[k][w];
  }
}

// grid (B): msgs[b, r, k] = sum over the nblk partials of slot b.
__global__ void __launch_bounds__(kThreads)
    partial_reduce_kernel(const uint32_t* partial, unsigned nblk, int32_t* msgs,
                          unsigned rounds, unsigned r, FieldConst<N> fc) {
  const unsigned b = blockIdx.x;
  uint32_t s[3][N];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int w = 0; w < N; ++w) s[k][w] = 0u;
  for (unsigned i = threadIdx.x; i < nblk; i += blockDim.x) {
    const uint32_t* src = partial + ((size_t)b * nblk + i) * (3 * N);
#pragma unroll
    for (int k = 0; k < 3; ++k) fadd<N>(s[k], s[k], src + k * N, fc);
  }
  block_reduce3(s, fc);
  if (threadIdx.x == 0) {
    int32_t* dst = msgs + ((size_t)b * rounds + r) * (3 * 2 * N);
#pragma unroll
    for (int k = 0; k < 3; ++k) store_limbs<N>(dst + k * 2 * N, s[k]);
  }
}

}  // namespace

// One product round for `batch` slots of width 2*half.  f_in/g_in: 16-bit
// limbs (in_limbs=1) or packed words; f_out/g_out likewise by out_limbs.
// partial: uint32 [batch, nblk, 3, 8] with nblk = ceil(half / 256).
// ch: the round's challenge, 16 int32 limbs.  consts: 8 modulus words, n0.
extern "C" int sczk_product_round(const void* f_in, const void* g_in, int in_limbs, void* f_out,
                                  void* g_out, int out_limbs, void* partial, const void* ch,
                                  int half, int nblk, int batch, const void* consts,
                                  void* stream) {
  if (half <= 0 || batch <= 0 || batch > 65535 || nblk <= 0 ||
      (long long)nblk * kThreads < half || (long long)(nblk - 1) * kThreads >= half) {
    return (int)cudaErrorInvalidValue;
  }
  const FieldConst<N> fc = field_const<N>(static_cast<const uint32_t*>(consts));
  dim3 grid(nblk, batch);
  product_round_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f_in, g_in, in_limbs, f_out, g_out, out_limbs, static_cast<uint32_t*>(partial),
      static_cast<const int32_t*>(ch), (unsigned)half, fc);
  return (int)cudaGetLastError();
}

// msgs: int32 [batch, rounds, 3, 16] (16-bit limbs); writes round r.
extern "C" int sczk_partial_reduce(const void* partial, int nblk, void* msgs, int rounds, int r,
                                   int batch, const void* consts, void* stream) {
  if (nblk <= 0 || batch <= 0 || r < 0 || r >= rounds) return (int)cudaErrorInvalidValue;
  const FieldConst<N> fc = field_const<N>(static_cast<const uint32_t*>(consts));
  partial_reduce_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(partial), (unsigned)nblk, static_cast<int32_t*>(msgs),
      (unsigned)rounds, (unsigned)r, fc);
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread: which 0 is the round
// kernel, 1 the partial reduce.  out: int32 [2].
extern "C" int sczk_sumcheck_attrs(int which, int* out) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, which == 0 ? reinterpret_cast<const void*>(&product_round_kernel)
                     : reinterpret_cast<const void*>(&partial_reduce_kernel));
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}
