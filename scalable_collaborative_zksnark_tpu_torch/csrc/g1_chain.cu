// The two chain-bound G1 kernels of the MSM for Hopper (sm_90a): the
// Horner window combine and the bucket-serial weighted reduce, on the
// low-latency Fq product of fq_chain.cuh.
//
// Replaces curves/pallas_g1.py:
//   horner_team_kernel   _horner_kernel (:358): sum_w 2^(c w) T_w over
//                        window totals [W, C], MSB window first: c
//                        doublings, then one general add;
//   bucket_segment_kernel _bucket_serial_kernel (:497): sum_{k>=1} k B_k
//                        over buckets [K, M].
//
// What bounds them on this card.  Both are chains of dependent point ops
// with few independent lanes: Horner has C lanes (3 in a commit, 39 in an
// open chain) of W (c + 1) point ops each; bucket-serial has M lanes of
// 2 (K - 2) general adds.  The card could do the work of either in well
// under a tenth of a millisecond; what takes the time is the length of
// one thread's chain times the latency of one Fq product, and fr.cuh's
// fmul takes about 2.1 us per product in a one-thread chain on an H100.
//
// What the design does about it.
// * The product: fq_mul_cc splits each CIOS row into two independent
//   carry-flag chains (fq_chain.cuh).
// * Horner: each column is worked by a team of kTeam lanes of one warp
//   (one block), on g1_team.cuh's group law by dependency levels: a
//   double costs 3 product latencies and an add 5, where one thread runs
//   7 and 16 products.  Since a level is at most 4 products wide, at most
//   4 of the 8 lanes are busy.  The column's W window totals are loaded
//   into shared memory first.  Doubling the first window's infinity c
//   times and adding the total gives the total itself, so the walk starts
//   from the MSB window's total: the same result, bit for bit.  159
//   registers, no spill.
// * Bucket-serial: each lane's buckets are cut into S segments of L =
//   ceil((K - 1) / S) buckets (S from bucket_segments in curves/cuda_g1.py,
//   which also the plain version reads).  One thread per (lane, segment)
//   runs the running suffix over its segment, k descending, giving R_s =
//   sum B_k and V_s = sum (k - sL) B_k; the thread of segment 0 then
//   combines them in shared memory: sum_k k B_k = sum_s V_s + L sum_s s R_s,
//   the inner sum by the same running suffix over R_{S-1} .. R_1 and the
//   factor L by MSB-first double-and-add.  With S = 1 there is no
//   combine and the schedule is the running suffix.  A lane's segments
//   share one block, neighbouring threads on neighbouring lanes (coalesced
//   bucket loads); each thread keeps its running total in shared memory,
//   so only the suffix and one bucket are live in registers.
// Every output is bit-equal to the plain versions horner_plain and
// bucket_serial_plain (curves/cuda_g1.py), which follow the same
// schedules with the same formulas.
#include <cuda_runtime.h>

#include <cstdint>

#include "g1_team.cuh"

namespace {

constexpr int kTeam = 8;                     // lanes per Horner column, one block
constexpr int kSegThreads = 64;              // bucket-serial threads per block
constexpr int kMaxHornerWindows = 48 * 1024 / (int)sizeof(Pt);

// tot: [W, C] window totals, window 0 least significant; one block of
// kTeam lanes per column, the column's totals in shared memory.
__global__ void __launch_bounds__(kTeam)
    horner_team_kernel(Coords tot, unsigned W, unsigned C, int cbits, OutCoords out, G1Const c) {
  extern __shared__ Pt win[];  // [W]
  const unsigned col = blockIdx.x;
  const Team<kTeam> tm = Team<kTeam>::here();
  for (unsigned w = tm.lane; w < W; w += kTeam) load_point(tot, (size_t)w * C + col, win[w]);
  __syncthreads();
  Pt acc = win[W - 1];
  for (int w = (int)W - 2; w >= 0; --w) {
    for (int j = 0; j < cbits; ++j) team_double(acc, acc, c, tm);
    team_add<false>(acc, acc, win[w], c, tm);
  }
  team_store(out, col, acc, tm);
}

// buckets: [K, M], bucket k ascending; S segments of L buckets per lane.
// blockDim = S * LB threads: thread t runs segment t / LB of lane
// blockIdx * LB + t % LB.  out[m] = sum_{k>=1} k B_k.
__global__ void __launch_bounds__(kSegThreads)
    bucket_segment_kernel(Coords buckets, unsigned K, unsigned M, unsigned S, OutCoords out,
                          G1Const c) {
  __shared__ Pt part_r[kSegThreads], part_v[kSegThreads];  // R_s and V_s of each thread
  const unsigned LB = blockDim.x / S;
  const unsigned t = threadIdx.x, seg = t / LB, ll = t % LB;
  const unsigned lane = blockIdx.x * LB + ll;
  const unsigned L = (K - 1 + S - 1) / S;
  Pt acc;
  set_infinity(acc, c);
  Pt& tot = part_v[t];
  set_infinity(tot, c);
  if (lane < M) {
    const int lo = (int)(seg * L + 1);
    const int hi = (int)min((seg + 1) * L, K - 1);
    for (int k = hi; k >= lo; --k) {
      Pt B;
      load_point(buckets, (size_t)k * M + lane, B);
      g1_add<FqMulCC>(acc, acc, B, c);
      g1_add<FqMulCC>(tot, tot, acc, c);
    }
  }
  part_r[t] = acc;
  __syncthreads();
  if (seg != 0 || lane >= M) return;
  Pt& sum = part_v[ll];  // sum_s V_s
  if (S > 1) {
    for (unsigned s = 1; s < S; ++s) g1_add<FqMulCC>(sum, sum, part_v[s * LB + ll], c);
    // sum_{s>=1} s R_s by the running suffix over R_{S-1} .. R_1: the
    // suffix in R_{S-1}'s slot, the weighted sum in V_{S-1}'s (read above)
    Pt& suf = part_r[(S - 1) * LB + ll];
    Pt& wsum = part_v[(S - 1) * LB + ll];
    wsum = suf;
    for (int s = (int)S - 2; s >= 1; --s) {
      g1_add<FqMulCC>(suf, suf, part_r[s * LB + ll], c);
      g1_add<FqMulCC>(wsum, wsum, suf, c);
    }
    // L * wsum, MSB first, in R_0's slot (R_0 has weight 0)
    Pt& scaled = part_r[ll];
    scaled = wsum;
    for (int b = 30 - __clz(L); b >= 0; --b) {
      g1_double<FqMulCC>(scaled, scaled, c);
      if ((L >> b) & 1u) g1_add<FqMulCC>(scaled, scaled, wsum, c);
    }
    g1_add<FqMulCC>(sum, sum, scaled, c);
  }
  store_point(out, lane, sum);
}

// One thread multiplies x by y n times with fq_mul_cc, each product
// depending on the last: the time over n is one product's latency in a
// chain, beside fq_mul_chain_kernel's for fmul (g1.cu).  A probe; it
// replaces no TPU kernel.
__global__ void fq_mul_cc_chain_kernel(const int32_t* a, int n, int32_t* out, FieldConst<NQ> f) {
  uint32_t x[NQ], y[NQ];
  load_limbs<NQ>(a, x);
  load_limbs<NQ>(a + 2 * NQ, y);
  for (int i = 0; i < n; ++i) fq_mul_cc(x, x, y, f);
  store_limbs<NQ>(out, x);
}

// out[i] = a[i] b[i] R^-1 with fq_mul_cc, one thread per element: holds
// the product against fmul (fr.cu's Fq mul) on many values.  A probe.
__global__ void fq_mul_cc_kernel(const int32_t* a, const int32_t* b, int32_t* out, unsigned m,
                                 FieldConst<NQ> f) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t x[NQ], y[NQ];
  load_limbs<NQ>(a + (size_t)i * 2 * NQ, x);
  load_limbs<NQ>(b + (size_t)i * 2 * NQ, y);
  fq_mul_cc(x, x, y, f);
  store_limbs<NQ>(out + (size_t)i * 2 * NQ, x);
}

}  // namespace

// Every coordinate is int32 [n, 24] (16-bit limbs, Montgomery form),
// contiguous and 16-byte aligned.  consts: 12 modulus words, n0, then 12
// words of Montgomery 1.  Each entry returns the launch's cudaError_t.

// tot: [W, C]; out: [C]; c: doublings per window.
extern "C" int sczk_g1_horner(const void* tx, const void* ty, const void* tz, int W, int C, int c,
                              void* ox, void* oy, void* oz, const void* consts, void* stream) {
  if (W <= 0 || C <= 0 || c <= 0 || W > kMaxHornerWindows) return (int)cudaErrorInvalidValue;
  horner_team_kernel<<<C, kTeam, W * sizeof(Pt), static_cast<cudaStream_t>(stream)>>>(
      coords(tx, ty, tz), (unsigned)W, (unsigned)C, c, out_coords(ox, oy, oz), consts_of(consts));
  return (int)cudaGetLastError();
}

// buckets: [K, M] with K >= 2; S segments per lane, 1 <= S <= 64; out: [M].
extern "C" int sczk_g1_bucket_serial(const void* bx, const void* by, const void* bz, int K, int M,
                                     int S, void* ox, void* oy, void* oz, const void* consts,
                                     void* stream) {
  if (K < 2 || M <= 0 || S < 1 || S > kSegThreads) return (int)cudaErrorInvalidValue;
  const int lanes = kSegThreads / S;  // lanes per block
  bucket_segment_kernel<<<(M + lanes - 1) / lanes, lanes * S, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      coords(bx, by, bz), (unsigned)K, (unsigned)M, (unsigned)S, out_coords(ox, oy, oz),
      consts_of(consts));
  return (int)cudaGetLastError();
}

// a, b: int32 [m, 24]; out: int32 [m, 24] = a b R^-1.
extern "C" int sczk_fq_mul_cc(const void* a, const void* b, void* out, int m, const void* consts,
                              void* stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  fq_mul_cc_kernel<<<(m + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), static_cast<int32_t*>(out),
      (unsigned)m, consts_of(consts).f);
  return (int)cudaGetLastError();
}

// a: int32 [2, 24] (x, y); out: int32 [24] = x y^n R^-n.
extern "C" int sczk_fq_mul_cc_chain(const void* a, int n, void* out, const void* consts,
                                    void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  fq_mul_cc_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), n, static_cast<int32_t*>(out), consts_of(consts).f);
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread of kernel `which`:
// 0 horner, 1 bucket_serial.  out: int32 [2].
extern "C" int sczk_g1_chain_attrs(int which, int* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(&horner_team_kernel),
      reinterpret_cast<const void*>(&bucket_segment_kernel),
  };
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}
