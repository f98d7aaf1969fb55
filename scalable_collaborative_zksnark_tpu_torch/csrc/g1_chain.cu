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
//   (one block).  At each dependency level of the double (3 levels: A,
//   B, YZ; then C, (X + B)^2, E^2; then E (D - X3)) and of the general
//   add (5 levels, at most 5 products wide) lane k computes the level's
//   k-th product, and the products are exchanged by warp shuffles.  Every
//   lane runs the same instructions on its own operands, so a level costs
//   one product's latency: a double 3 products deep and an add 5, where
//   one thread runs 7 and 16.  The linear steps are computed by every
//   lane on the values all of them hold, so the infinity and x-collision
//   branches are taken by the whole team alike.  The column's W window
//   totals are loaded into shared memory first.  Doubling the first
//   window's infinity c times and adding the total gives the total
//   itself, so the walk starts from the MSB window's total: the same
//   result, bit for bit.
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

#include "fq_chain.cuh"
#include "g1.cuh"

namespace {

constexpr int kTeam = 8;                     // lanes per Horner column
constexpr unsigned kTeamMask = 0xFFu;        // the block's lanes 0 .. 7
constexpr int kSegThreads = 64;              // bucket-serial threads per block
constexpr int kMaxHornerWindows = 48 * 1024 / (int)sizeof(Pt);

// The group law of g1.cuh on fq_mul_cc.
struct FqMulCC {
  __device__ __forceinline__ static void mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                             const FieldConst<NQ>& f) {
    fq_mul_cc(r, a, b, f);
  }
};

// One product of a team level: r = a b.
struct Prod {
  const uint32_t* a;
  const uint32_t* b;
  uint32_t* r;
};

// The K independent products of one level: lane k computes the k-th
// (lanes past K repeat the first), then every lane reads each result from
// the lane that computed it.  Every lane must hold the same operands.
template <int K>
__device__ __forceinline__ void team_level(const Prod (&ps)[K], unsigned lane,
                                           const FieldConst<NQ>& f) {
  uint32_t x[NQ], y[NQ], p[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    x[j] = ps[0].a[j];
    y[j] = ps[0].b[j];
  }
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const bool mine = lane == (unsigned)k;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      x[j] = mine ? ps[k].a[j] : x[j];
      y[j] = mine ? ps[k].b[j] : y[j];
    }
  }
  fq_mul_cc(p, x, y, f);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) ps[k].r[j] = K == 1 ? p[j] : __shfl_sync(kTeamMask, p[j], k, kTeam);
  }
}

// dbl-2009-l as g1_double, by levels; r may alias p.
__device__ __forceinline__ void team_double(Pt& r, const Pt& p, const G1Const& c, unsigned lane) {
  const FieldConst<NQ>& f = c.f;
  const bool inf = fq_is_zero(p.z);
  uint32_t A[NQ], B[NQ], YZ[NQ], t[NQ], E[NQ], C[NQ], T2[NQ], G[NQ], D[NQ], u[NQ], Y3[NQ];
  team_level<3>({{p.x, p.x, A}, {p.y, p.y, B}, {p.y, p.z, YZ}}, lane, f);
  fadd<NQ>(t, p.x, B, f);
  fadd<NQ>(E, A, A, f);
  fadd<NQ>(E, E, A, f);  // E = 3A
  team_level<3>({{B, B, C}, {t, t, T2}, {E, E, G}}, lane, f);
  fsub<NQ>(D, T2, A, f);
  fsub<NQ>(D, D, C, f);
  fadd<NQ>(D, D, D, f);  // D = 2((X + B)^2 - A - C)
  fadd<NQ>(u, D, D, f);
  fsub<NQ>(r.x, G, u, f);  // X3 = E^2 - 2D
  fsub<NQ>(u, D, r.x, f);
  team_level<1>({{E, u, Y3}}, lane, f);
  fadd<NQ>(C, C, C, f);
  fadd<NQ>(C, C, C, f);
  fadd<NQ>(C, C, C, f);  // 8C
  fsub<NQ>(r.y, Y3, C, f);  // Y3 = E (D - X3) - 8C
  if (inf) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) r.z[j] = 0u;
  } else {
    fadd<NQ>(r.z, YZ, YZ, f);  // Z3 = 2 Y Z
  }
}

// Complete add-2007-bl as g1_add<false>, by levels; r may alias p1.
__device__ __forceinline__ void team_add(Pt& r, const Pt& p1, const Pt& p2, const G1Const& c,
                                         unsigned lane) {
  if (fq_is_zero(p1.z)) {
    r = p2;
    return;
  }
  if (fq_is_zero(p2.z)) {
    r = p1;
    return;
  }
  const FieldConst<NQ>& f = c.f;
  uint32_t ZS[NQ], Z1Z1[NQ], Z2Z2[NQ], Y1Z2[NQ], Y2Z1[NQ], ZS2[NQ];
  uint32_t U1[NQ], S1[NQ], U2[NQ], S2[NQ], H[NQ], R[NQ];
  fadd<NQ>(ZS, p1.z, p2.z, f);
  team_level<5>({{p1.z, p1.z, Z1Z1}, {p2.z, p2.z, Z2Z2}, {p1.y, p2.z, Y1Z2}, {p2.y, p1.z, Y2Z1},
                 {ZS, ZS, ZS2}}, lane, f);
  team_level<4>({{p1.x, Z2Z2, U1}, {Y1Z2, Z2Z2, S1}, {p2.x, Z1Z1, U2}, {Y2Z1, Z1Z1, S2}}, lane, f);
  fsub<NQ>(H, U2, U1, f);
  fsub<NQ>(R, S2, S1, f);
  if (fq_is_zero(H)) {
    if (fq_is_zero(R)) {
      team_double(r, p1, c, lane);
    } else {
      set_infinity(r, c);
    }
    return;
  }
  uint32_t t[NQ], HH[NQ], Z3[NQ], I[NQ], J[NQ], V[NQ], R2[NQ], T[NQ], SJ[NQ];
  fsub<NQ>(t, ZS2, Z1Z1, f);
  fsub<NQ>(t, t, Z2Z2, f);
  team_level<2>({{H, H, HH}, {t, H, Z3}}, lane, f);  // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  fadd<NQ>(I, HH, HH, f);
  fadd<NQ>(I, I, I, f);  // I = 4 HH
  fadd<NQ>(R, R, R, f);  // r2 = 2r
  team_level<3>({{H, I, J}, {U1, I, V}, {R, R, R2}}, lane, f);
  fsub<NQ>(R2, R2, J, f);
  fadd<NQ>(t, V, V, f);
  fsub<NQ>(r.x, R2, t, f);  // X3 = r2^2 - J - 2V
  fsub<NQ>(t, V, r.x, f);
  team_level<2>({{R, t, T}, {S1, J, SJ}}, lane, f);
  fadd<NQ>(SJ, SJ, SJ, f);
  fsub<NQ>(r.y, T, SJ, f);  // Y3 = r2 (V - X3) - 2 S1 J
  fq_copy(r.z, Z3);
}

// tot: [W, C] window totals, window 0 least significant; one block of
// kTeam lanes per column, the column's totals in shared memory.
__global__ void __launch_bounds__(kTeam)
    horner_team_kernel(Coords tot, unsigned W, unsigned C, int cbits, OutCoords out, G1Const c) {
  extern __shared__ Pt win[];  // [W]
  const unsigned col = blockIdx.x, lane = threadIdx.x;
  for (unsigned w = lane; w < W; w += kTeam) load_point(tot, (size_t)w * C + col, win[w]);
  __syncthreads();
  Pt acc = win[W - 1];
  for (int w = (int)W - 2; w >= 0; --w) {
    for (int j = 0; j < cbits; ++j) team_double(acc, acc, c, lane);
    team_add(acc, acc, win[w], c, lane);
  }
  if (lane == 0) store_point(out, col, acc);
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
      g1_add<false, FqMulCC>(acc, acc, B, c);
      g1_add<false, FqMulCC>(tot, tot, acc, c);
    }
  }
  part_r[t] = acc;
  __syncthreads();
  if (seg != 0 || lane >= M) return;
  Pt& sum = part_v[ll];  // sum_s V_s
  if (S > 1) {
    for (unsigned s = 1; s < S; ++s) g1_add<false, FqMulCC>(sum, sum, part_v[s * LB + ll], c);
    // sum_{s>=1} s R_s by the running suffix over R_{S-1} .. R_1: the
    // suffix in R_{S-1}'s slot, the weighted sum in V_{S-1}'s (read above)
    Pt& suf = part_r[(S - 1) * LB + ll];
    Pt& wsum = part_v[(S - 1) * LB + ll];
    wsum = suf;
    for (int s = (int)S - 2; s >= 1; --s) {
      g1_add<false, FqMulCC>(suf, suf, part_r[s * LB + ll], c);
      g1_add<false, FqMulCC>(wsum, wsum, suf, c);
    }
    // L * wsum, MSB first, in R_0's slot (R_0 has weight 0)
    Pt& scaled = part_r[ll];
    scaled = wsum;
    for (int b = 30 - __clz(L); b >= 0; --b) {
      g1_double<FqMulCC>(scaled, scaled, c);
      if ((L >> b) & 1u) g1_add<false, FqMulCC>(scaled, scaled, wsum, c);
    }
    g1_add<false, FqMulCC>(sum, sum, scaled, c);
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
