// Sumcheck product fold phase for Hopper (sm_90a): one launch a phase.
//
// Replaces primitives/pallas_sumcheck.py:38 _phase_kernel (its
// pallas_call at :130, via product_phase).  For a batch of B table pairs
// f, g of M = 2^R evaluations it computes, for every round r, the messages
//   t0 = sum lo_f*lo_g,  t1 = sum hi_f*hi_g,  t2 = sum (2hi_f-lo_f)(2hi_g-lo_g)
// as canonical field elements, and folds both tables to lo + c_r (hi - lo)
// with c_r = ch[r].  Outputs: the R messages as 16-bit limbs and the two
// folded finals.
//
// Design.  The TPU kernel runs the whole phase as one pallas_call with
// both tables resident in VMEM.  Here, too, a phase is one launch of
// phase_cluster_kernel at every M <= 2^13 (the wrapper's TAIL_MAX; the
// prove's tables are 2^15 at most): each batch slot gets a thread block
// cluster of K blocks of 512 threads (cudaLaunchKernelEx, K <= 8,
// portable).  Block q of a cluster owns the elements j = q + K i of its
// slot's table.  Every round folds j with j + M/2^(r+1), and while that
// distance is at least K both lie in the same block (same j mod K), so the
// block folds its own sub-table of M/K elements alone: the first round
// reads the 16-bit limbs from device memory (16-byte loads, one element
// of f and g at lo and hi a pair), writes the folded halves to shared
// memory as packed 32-bit words (32 B an element), and later rounds fold
// in place (pair i reads lo[i] and hi[i + half], writes lo[i];
// __syncthreads between rounds).  While a round has a pair for every
// thread, each thread folds whole pairs; in the thinner rounds a team of
// up to 8 lanes shares a pair, one of its five products a lane, so a
// round's chain is one product, not five.  After log2(M/K) rounds each
// block holds one element; block 0 gathers the K of them from the
// cluster's distributed shared memory (map_shared_rank) and runs the last
// log2 K rounds in one warp.  No fold waits for a message: all R
// challenges are inputs (in shared memory from the start).  Each warp
// shuffle-reduces its three partial sums of a round into its slot of a
// [rounds, 3, warps, 8] word array in shared memory, except in the thin
// rounds (at most 64 pairs, teams of 8), where each message product is
// stored as its own term instead: a per-round warp sum there cost more
// than the round's product (on an H100 at 700 W, the same kernel with
// whole pairs a thread and slots in every round took 0.056 against 0.048
// ms at [6, 2^13], 0.024 against 0.014 at [3, 64]:
// scripts/chain_bench.py).  After the folds the cluster reduces every
// round's slots or terms (sum p of the 3R goes to block p mod K, warp by
// warp, reading the other blocks' shared memory remotely) and writes the
// canonical messages.  Three cluster.sync()s: after the blocks' folds,
// after block 0's last rounds, and before any block exits (its shared
// memory must outlive the remote reads).
//
// K = clamp(M / 128, 1, 8) (chosen by the wrapper): the first round
// holds half of all products, and at the gate identity's [6, 2^13] one
// block a slot would put them on 6 SMs; K = 8 spreads them over 48, one
// pair a thread (M/K/2 = 512 pairs).  Below M = 1024 a slot's work is a
// few microseconds on one SM and K falls with M.  (A non-portable K = 16
// took 0.043 against 0.048 ms there: not worth leaving the portable size.)
// Shared memory a block: 64 B (M/K/2) for the tables, 1.5 KB a round for
// the slots, 13 KB of terms, 66 KB at M = 2^13 and K = 8; up to 227 KB is
// accepted (above 48 KB the C entry raises the limit on every call: it
// is the current device's).
//
// Larger tables (the prove's wire 2.c at 2^15, the envelope's [1, 2^21]
// and [1, 2^25]): head rounds run first as streaming launches of
// phase_head_kernel over all SMs (at most kHeadBlocks blocks a slot, each
// thread striding over pairs), each writing its folded tables as words and
// every block's three partial sums to a [B, head, kHeadBlocks, 3, 8]
// scratch, until the table is 2^13; then the cluster kernel runs the rest
// and its final reduce also covers the head rounds' partials.  No
// per-round reduce launch.
//
// The products run on fr_mul_cc and the adds and subtracts on fr_add_cc /
// fr_sub_cc (fq_chain.cuh, N = 8): carry-flag chains, bit-equal to
// fmul<8>, fadd<8> and fsub<8> for canonical inputs (every operand here
// is canonical: loads of canonical limbs, outputs of these functions).
//
// Bound: 5 Montgomery products per pair and round (t0, t1, t2, the two
// folds), B (M - 1) pairs in all, 264 32-bit multiplies a product: at
// [6, 2^13] 65 M multiplies, 3.9 us at the card's integer rate, against
// 6.3 MB read (1.9 us at HBM rate): bound by operations.  The chain of a
// round is fsub -> product -> fadd, at least cios_depth(8) = 38 dependent
// multiply-adds (0.19 us), 2.5 us over 13 rounds, below the operations
// term.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fq_chain.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int N = 8;                 // Fr: 8 words
constexpr int kThreads = 512;        // threads of a cluster block
constexpr int kWarps = kThreads / 32;
constexpr int kHeadThreads = 256;    // threads of a head block
constexpr unsigned kHeadBlocks = 1024;  // most head blocks a slot and round
constexpr int kMaxCluster = 8;       // portable cluster size
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block may have (227 KB)
constexpr int kDefaultSmem = 48 * 1024;
// A round of at most kThinPairs pairs (every round of block 0's last log2 K)
// runs a team of 8 lanes a pair, and each message product goes to its own
// term in shared memory instead of a per-round warp sum.
constexpr unsigned kThinPairs = kThreads / 8;
constexpr unsigned kTermWords = 3 * N * (2 * kThinPairs + kMaxCluster);

__host__ __device__ inline int ilog2(unsigned long long x) {
  int r = 0;
  while (x >>= 1) ++r;
  return r;
}

// Head blocks of a round over `half` pairs of one slot.
__host__ __device__ inline unsigned head_blocks(unsigned long long half) {
  const unsigned long long n = (half + kHeadThreads - 1) / kHeadThreads;
  return n < kHeadBlocks ? (unsigned)n : kHeadBlocks;
}

// Table elements a cluster block keeps after its first round.
__host__ __device__ inline unsigned table_cap(unsigned m_tail, unsigned k) {
  const unsigned n_loc = m_tail / k;
  return n_loc > 1 ? n_loc / 2 : 1;
}

// Dynamic shared memory of a cluster block, in 32-bit words: the f and g
// tables, the K gathered elements of each, the round slots, the rounds'
// challenges, the thin rounds' terms.
__host__ __device__ inline unsigned long long smem_words(unsigned m_tail, unsigned k) {
  return 2ull * N * table_cap(m_tail, k) + 2ull * N * k +
         (unsigned long long)ilog2(m_tail) * (3 * kWarps + 1) * N + kTermWords;
}

// Where a thin round of P pairs keeps its terms [3][P][N]: the block's own
// rounds (P <= kThinPairs, halving) first, then block 0's last rounds
// (P <= kMaxCluster / 2).
__device__ __forceinline__ unsigned term_offset(unsigned P, bool last) {
  return 3 * N * (last ? 2 * kThinPairs + kMaxCluster - 2 * P : 2 * kThinPairs - 2 * P);
}

__device__ __forceinline__ void warp_reduce(uint32_t* v, const FieldConst<N>& f) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    uint32_t o[N];
#pragma unroll
    for (int w = 0; w < N; ++w) o[w] = __shfl_down_sync(0xffffffffu, v[w], off);
    fr_add_cc(v, v, o, f);
  }
}

__device__ __forceinline__ void zero3(uint32_t (&s)[3][N]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int w = 0; w < N; ++w) s[k][w] = 0u;
}

// One pair: s += (lo_f lo_g, hi_f hi_g, (2hi_f - lo_f)(2hi_g - lo_g)), and
// lf, lg become lo + c (hi - lo).
__device__ __forceinline__ void fold_pair(uint32_t* lf, const uint32_t* hf, uint32_t* lg,
                                          const uint32_t* hg, const uint32_t* c,
                                          uint32_t (&s)[3][N], const FieldConst<N>& fc) {
  uint32_t p[N], df[N], dg[N], ef[N], eg[N];
  fr_mul_cc(p, lf, lg, fc);
  fr_add_cc(s[0], s[0], p, fc);
  fr_mul_cc(p, hf, hg, fc);
  fr_add_cc(s[1], s[1], p, fc);
  fr_sub_cc(df, hf, lf, fc);
  fr_sub_cc(dg, hg, lg, fc);
  fr_add_cc(ef, hf, df, fc);  // 2 hi - lo = hi + (hi - lo)
  fr_add_cc(eg, hg, dg, fc);
  fr_mul_cc(p, ef, eg, fc);
  fr_add_cc(s[2], s[2], p, fc);
  fr_mul_cc(df, c, df, fc);
  fr_add_cc(lf, lf, df, fc);
  fr_mul_cc(dg, c, dg, fc);
  fr_add_cc(lg, lg, dg, fc);
}

__device__ __forceinline__ void load_elem(const void* base, size_t idx, int limbs, uint32_t* w) {
  if (limbs) {
    load_limbs<N>(static_cast<const int32_t*>(base) + idx * (2 * N), w);
  } else {
    load_words<N>(static_cast<const uint32_t*>(base) + idx * N, w);
  }
}

// Lane l of a team of S lanes that shares pair i of P: the products of
// roles l, l + S, .. of (fold f, fold g, t2, t0, t1), one product at a time
// with the operands selected, so the team's lanes run one instruction
// stream.  A fold is stored to of / og; a message product t_k is added to
// s[k], or stored as term k of the pair where `terms` is given.
__device__ __forceinline__ void team_pair(const uint32_t* lf, const uint32_t* hf,
                                          const uint32_t* lg, const uint32_t* hg,
                                          const uint32_t* c, unsigned l, unsigned S, uint32_t* of,
                                          uint32_t* og, uint32_t* terms, unsigned i, unsigned P,
                                          uint32_t (&s)[3][N], const FieldConst<N>& fc) {
  uint32_t df[N], dg[N], ef[N], eg[N], x[N], y[N], p[N];
  fr_sub_cc(df, hf, lf, fc);
  fr_sub_cc(dg, hg, lg, fc);
  fr_add_cc(ef, hf, df, fc);
  fr_add_cc(eg, hg, dg, fc);
  for (unsigned role = l; role < 5; role += S) {
#pragma unroll
    for (int w = 0; w < N; ++w) {
      x[w] = role < 2 ? c[w] : role == 2 ? ef[w] : role == 3 ? lf[w] : hf[w];
      y[w] = role == 0 ? df[w] : role == 1 ? dg[w] : role == 2 ? eg[w] : role == 3 ? lg[w] : hg[w];
    }
    fr_mul_cc(p, x, y, fc);
    if (role < 2) {
#pragma unroll
      for (int w = 0; w < N; ++w) x[w] = role == 0 ? lf[w] : lg[w];
      fr_add_cc(p, x, p, fc);
      store_words<N>(role == 0 ? of : og, p);
    } else if (terms) {
      store_words<N>(terms + ((role == 2 ? 2 : role - 3) * P + i) * N, p);
    } else if (role == 2) {
      fr_add_cc(s[2], s[2], p, fc);
    } else if (role == 3) {
      fr_add_cc(s[0], s[0], p, fc);
    } else {
      fr_add_cc(s[1], s[1], p, fc);
    }
  }
}

// One round over P pairs by `nthreads` threads (this one `tid`): load(i,
// lf, hf, lg, hg) reads pair i, the folds go to tf[i], tg[i] (in place or
// not).  While P >= nthreads each thread folds whole pairs (throughput);
// below, a team of S = min(8, nthreads / P) lanes of one warp shares a pair
// (latency: one product on the round's chain where a thread would chain
// five); `terms` (thin rounds, S = 8) takes the message products.  Returns
// the threads that took part (a prefix of the block).
template <class Load>
__device__ __forceinline__ unsigned fold_round(Load load, uint32_t* tf, uint32_t* tg, unsigned P,
                                               unsigned nthreads, unsigned tid, const uint32_t* c,
                                               uint32_t* terms, uint32_t (&s)[3][N],
                                               const FieldConst<N>& fc) {
  uint32_t lf[N], hf[N], lg[N], hg[N];
  if (P >= nthreads) {
    for (unsigned i = tid; i < P; i += nthreads) {
      load(i, lf, hf, lg, hg);
      fold_pair(lf, hf, lg, hg, c, s, fc);
      store_words<N>(tf + N * i, lf);
      store_words<N>(tg + N * i, lg);
    }
    return nthreads;
  }
  const unsigned S = nthreads / P < 8 ? nthreads / P : 8;
  const unsigned i = tid / S;
  if (i < P) load(i, lf, hf, lg, hg);
  __syncwarp();  // the team's reads before its writes
  if (i < P) team_pair(lf, hf, lg, hg, c, tid % S, S, tf + N * i, tg + N * i, terms, i, P, s, fc);
  return P * S;
}

// Each warp's field sums of a round into its slots [3][kWarps][N]: the
// first `busy` threads of the block took part (a power of two or a
// multiple of 32), so a warp sums its lanes below min(32, busy - 32 warp)
// in that many halvings; a warp with none writes zeros.
__device__ __forceinline__ void put_slots(uint32_t* slots, uint32_t (&s)[3][N], unsigned busy,
                                          const FieldConst<N>& fc) {
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned first = warp * 32;
  const unsigned lanes = busy <= first ? 0 : busy - first < 32 ? busy - first : 32;
  for (unsigned off = lanes / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint32_t o[N];
#pragma unroll
      for (int w = 0; w < N; ++w) o[w] = __shfl_down_sync(0xffffffffu, s[k][w], off);
      fr_add_cc(s[k], s[k], o, fc);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) store_words<N>(slots + (k * kWarps + warp) * N, s[k]);
  }
}

// Field sum of s[k] over the block; thread 0 ends with the totals.
__device__ __forceinline__ void block_reduce3(uint32_t (&s)[3][N], const FieldConst<N>& f) {
  __shared__ uint32_t sh[kHeadThreads / 32][3][N];
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

// grid (head_blocks(half), B): head round r over the pairs (j, j + half)
// of slot blockIdx.y, each thread striding by the grid.  in: limbs
// (in_limbs) or words, slot stride in_stride elements; out: words, slot
// stride out_stride.  partial[b, r, blockIdx.x, 3, 8]: the block's sums.
__global__ void __launch_bounds__(kHeadThreads)
    phase_head_kernel(const void* f_in, const void* g_in, int in_limbs, size_t in_stride,
                      uint32_t* f_out, uint32_t* g_out, size_t out_stride, uint32_t* partial,
                      int r, int head, const int32_t* ch, size_t half, FieldConst<N> fc) {
  const size_t b = blockIdx.y;
  uint32_t s[3][N], c[N];
  zero3(s);
  load_limbs<N>(ch + r * 2 * N, c);
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < half;
       j += (size_t)gridDim.x * blockDim.x) {
    uint32_t lf[N], hf[N], lg[N], hg[N];
    const size_t lo = b * in_stride + j;
    load_elem(f_in, lo, in_limbs, lf);
    load_elem(f_in, lo + half, in_limbs, hf);
    load_elem(g_in, lo, in_limbs, lg);
    load_elem(g_in, lo + half, in_limbs, hg);
    fold_pair(lf, hf, lg, hg, c, s, fc);
    store_words<N>(f_out + (b * out_stride + j) * N, lf);
    store_words<N>(g_out + (b * out_stride + j) * N, lg);
  }
  block_reduce3(s, fc);
  if (threadIdx.x == 0) {
    uint32_t* out = partial + ((b * head + r) * kHeadBlocks + blockIdx.x) * (3 * N);
#pragma unroll
    for (int k = 0; k < 3; ++k) store_words<N>(out + k * N, s[k]);
  }
}

// grid K * B in clusters of K, kThreads each: the last log2(m_tail)
// rounds of slot blockIdx.x / K over its table of m_tail elements (limbs
// or words by in_limbs, slot stride in_stride), then every round's
// messages: rounds below `head` from the head kernels' partials (the
// phase's table had m_full elements).  ch: the phase's R challenges;
// msgs: [B, R, 3, 16] limbs; ff, fg: [B, 16] limbs.
__global__ void __launch_bounds__(kThreads, 1)
    phase_cluster_kernel(const void* f_in, const void* g_in, int in_limbs, size_t in_stride,
                         unsigned m_tail, int head, unsigned long long m_full,
                         const uint32_t* partial, const int32_t* ch, int32_t* msgs, int32_t* ff,
                         int32_t* fg, FieldConst<N> fc) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned K = cluster.num_blocks();
  const unsigned q = cluster.block_rank();
  const size_t b = blockIdx.x / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned n_loc = m_tail / K;
  const int r_loc = ilog2(n_loc), r_tail = ilog2(m_tail), R = head + r_tail;
  const unsigned cap = table_cap(m_tail, K);
  const int slot_words = 3 * kWarps * N;  // one round's slots

  extern __shared__ uint4 smem_raw[];
  uint32_t* tf = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* tg = tf + N * cap;
  uint32_t* gf = tg + N * cap;  // the K elements block 0 gathers
  uint32_t* gg = gf + N * K;
  uint32_t* slots = gg + N * K;
  uint32_t* chs = slots + r_tail * slot_words;  // round t's challenge at chs[N t]
  uint32_t* terms = chs + r_tail * N;

  uint32_t s[3][N], c[N];
  if (tid < r_tail) {  // the challenges, off the rounds' chains
    load_limbs<N>(ch + (head + tid) * 2 * N, c);
    store_words<N>(chs + N * tid, c);
  }

  // first round: from device memory into shared memory
  const size_t base = b * in_stride;
  if (n_loc >= 2) {
    zero3(s);
    load_limbs<N>(ch + head * 2 * N, c);
    auto from_memory = [&](unsigned i, uint32_t* lf, uint32_t* hf, uint32_t* lg, uint32_t* hg) {
      const size_t j = base + q + (size_t)K * i;
      load_elem(f_in, j, in_limbs, lf);
      load_elem(f_in, j + m_tail / 2, in_limbs, hf);
      load_elem(g_in, j, in_limbs, lg);
      load_elem(g_in, j + m_tail / 2, in_limbs, hg);
    };
    const unsigned P = n_loc / 2;
    const bool thin = P <= kThinPairs;
    const unsigned busy = fold_round(from_memory, tf, tg, P, kThreads, tid, c,
                                     thin ? terms + term_offset(P, false) : nullptr, s, fc);
    if (!thin) put_slots(slots, s, busy, fc);
  } else if (tid == 0) {  // one element a block: the table's q-th, unfolded
    uint32_t w[N];
    load_elem(f_in, base + q, in_limbs, w);
    store_words<N>(tf, w);
    load_elem(g_in, base + q, in_limbs, w);
    store_words<N>(tg, w);
  }
  __syncthreads();

  // the block's other rounds, in place
  for (int t = 1; t < r_loc; ++t) {
    const unsigned P = n_loc >> (t + 1);
    zero3(s);
    load_words<N>(chs + N * t, c);
    auto from_table = [&](unsigned i, uint32_t* lf, uint32_t* hf, uint32_t* lg, uint32_t* hg) {
      load_words<N>(tf + N * i, lf);
      load_words<N>(tf + N * (i + P), hf);
      load_words<N>(tg + N * i, lg);
      load_words<N>(tg + N * (i + P), hg);
    };
    const bool thin = P <= kThinPairs;
    const unsigned busy = fold_round(from_table, tf, tg, P, kThreads, tid, c,
                                     thin ? terms + term_offset(P, false) : nullptr, s, fc);
    if (!thin) put_slots(slots + t * slot_words, s, busy, fc);
    __syncthreads();
  }
  cluster.sync();

  // the last log2 K rounds over the blocks' K elements, in block 0's warp 0
  if (q == 0 && warp == 0) {
    uint32_t* xf = tf;
    uint32_t* xg = tg;
    if (K > 1) {
      if ((unsigned)lane < K) {
        uint32_t w[N];
        load_words<N>(cluster.map_shared_rank(tf, lane), w);
        store_words<N>(gf + N * lane, w);
        load_words<N>(cluster.map_shared_rank(tg, lane), w);
        store_words<N>(gg + N * lane, w);
      }
      __syncwarp();
      xf = gf;
      xg = gg;
    }
    for (int t = r_loc; t < r_tail; ++t) {
      const unsigned P = m_tail >> (t + 1);
      zero3(s);
      load_words<N>(chs + N * t, c);
      auto from_gathered = [&](unsigned i, uint32_t* lf, uint32_t* hf, uint32_t* lg, uint32_t* hg) {
        load_words<N>(xf + N * i, lf);
        load_words<N>(xf + N * (i + P), hf);
        load_words<N>(xg + N * i, lg);
        load_words<N>(xg + N * (i + P), hg);
      };
      fold_round(from_gathered, xf, xg, P, 32, lane, c, terms + term_offset(P, true), s, fc);
      __syncwarp();
    }
    if (lane == 0) {
      uint32_t w[N];
      load_words<N>(xf, w);
      store_limbs<N>(ff + b * 2 * N, w);
      load_words<N>(xg, w);
      store_limbs<N>(fg + b * 2 * N, w);
    }
  }
  cluster.sync();

  // every round's messages: sum p = 3 r + k goes to block p mod K, warp by warp
  for (int p = q + K * warp; p < 3 * R; p += K * kWarps) {
    const int r = p / 3, k = p % 3;
    uint32_t v[N], w[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = 0u;
    if (r < head) {
      const unsigned nblk = head_blocks(m_full >> (r + 1));
      const uint32_t* src = partial + (b * head + r) * kHeadBlocks * (3 * N) + k * N;
      for (unsigned e = lane; e < nblk; e += 32) {
        load_words<N>(src + (size_t)e * (3 * N), w);
        fr_add_cc(v, v, w, fc);
      }
    } else if (r - head >= r_loc) {  // block 0's last rounds: its terms
      const unsigned P = m_tail >> (r - head + 1);
      const uint32_t* src = terms + term_offset(P, true) + k * P * N;
      for (unsigned e = lane; e < P; e += 32) {
        load_words<N>(cluster.map_shared_rank(src + e * N, 0), w);
        fr_add_cc(v, v, w, fc);
      }
    } else if (const unsigned P = n_loc >> (r - head + 1); P <= kThinPairs) {  // every block's terms
      const uint32_t* src = terms + term_offset(P, false) + k * P * N;
      for (unsigned e = lane; e < K * P; e += 32) {
        load_words<N>(cluster.map_shared_rank(src + (e % P) * N, e / P), w);
        fr_add_cc(v, v, w, fc);
      }
    } else {  // every block's warp sums
      const uint32_t* src = slots + ((r - head) * 3 + k) * kWarps * N;
      for (unsigned e = lane; e < K * kWarps; e += 32) {
        load_words<N>(cluster.map_shared_rank(src + (e % kWarps) * N, e / kWarps), w);
        fr_add_cc(v, v, w, fc);
      }
    }
    warp_reduce(v, fc);
    if (lane == 0) store_limbs<N>(msgs + ((b * R + r) * 3 + k) * (2 * N), v);
  }
  cluster.sync();  // no block leaves while another may read its slots
}

// One thread multiplies x by y n times, each product depending on the
// last, by fr_mul_cc (CC) or fmul<8>: one product's latency in a chain.
// A probe; it replaces no TPU kernel.
template <bool CC>
__global__ void fr_mul_chain_kernel(const int32_t* a, int n, int32_t* out, FieldConst<N> f) {
  uint32_t x[N], y[N];
  load_limbs<N>(a, x);
  load_limbs<N>(a + 2 * N, y);
  for (int i = 0; i < n; ++i) {
    if (CC) {
      fr_mul_cc(x, x, y, f);
    } else {
      fmul<N>(x, x, y, f);
    }
  }
  store_limbs<N>(out, x);
}

// out[i] = a[i] b[i] R^-1 by fr_mul_cc, one thread an element: holds the
// product against fmul<8> (fr.cu's Fr mul) on many values.  A probe.
__global__ void fr_mul_cc_kernel(const int32_t* a, const int32_t* b, int32_t* out, unsigned m,
                                 FieldConst<N> f) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t x[N], y[N];
  load_limbs<N>(a + (size_t)i * 2 * N, x);
  load_limbs<N>(b + (size_t)i * 2 * N, y);
  fr_mul_cc(x, x, y, f);
  store_limbs<N>(out + (size_t)i * 2 * N, x);
}

// Scratch of a phase with `head` head rounds over `batch` slots of M
// elements, in 32-bit words: the head rounds' f and g tables ([batch, 3M/4,
// 8] each: a round writes M/2 elements a slot, the next M/4 beside them,
// the next over the first) and their partial sums ([batch, head,
// kHeadBlocks, 3, 8]); 0 without head rounds.
__host__ __device__ inline unsigned long long head_table_words(long long M, int batch) {
  return (unsigned long long)batch * (unsigned long long)(M / 4 * 3) * N;
}
__host__ __device__ inline unsigned long long scratch_words(long long M, int batch, int head) {
  if (head <= 0) return 0;
  return 2 * head_table_words(M, batch) + (unsigned long long)batch * head * kHeadBlocks * 3 * N;
}

}  // namespace

// Shared memory of a cluster block (bytes) for a table of m_tail elements
// over a cluster of k blocks.
extern "C" int sczk_phase_smem(int m_tail, int k) {
  if (m_tail < 2 || k < 1 || k > m_tail) return -1;
  return (int)(smem_words((unsigned)m_tail, (unsigned)k) * 4);
}

// out[0] = the scratch words sczk_product_phase needs (see scratch_words).
extern "C" int sczk_phase_scratch_words(long long M, int batch, int head, long long* out) {
  if (M < 2 || batch <= 0 || head < 0) return (int)cudaErrorInvalidValue;
  out[0] = (long long)scratch_words(M, batch, head);
  return 0;
}

// One phase over `batch` slots of M = 2^R elements.  f, g: int32 [batch,
// M, 16] limbs; ch: the phase's R challenges, int32 [R, 16]; msgs: int32
// [batch, R, 3, 16]; ff, fg: int32 [batch, 16]; K: the cluster (1, 2, 4
// or 8, at most M >> head); head: streaming rounds before the cluster
// kernel (0 <= head < R); scratch: sczk_phase_scratch_words words (may be
// null without head rounds).  consts: 8 modulus words, n0.  Returns the
// first failed launch's cudaError_t, or 0; launches head + 1 kernels.
extern "C" int sczk_product_phase(const void* f, const void* g, const void* ch, void* msgs,
                                  void* ff, void* fg, void* scratch, long long M, int batch, int K,
                                  int head, const void* consts, void* stream) {
  const int R = ilog2((unsigned long long)(M > 0 ? M : 1));
  if (M < 2 || (M & (M - 1)) || batch <= 0 || head < 0 || head >= R ||
      (K != 1 && K != 2 && K != 4 && K != kMaxCluster) || K > (M >> head) ||
      (long long)K * batch > 0x7fffffffLL || batch > 65535 ||
      (head > 0 && !scratch)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned m_tail = (unsigned)(M >> head);
  const unsigned long long smem = smem_words(m_tail, (unsigned)K) * 4;
  if (smem > (unsigned long long)kMaxSmem) return (int)cudaErrorInvalidValue;
  const FieldConst<N> fc = field_const<N>(static_cast<const uint32_t*>(consts));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (smem > (unsigned long long)kDefaultSmem) {  // the limit is the current device's: every call
    err = cudaFuncSetAttribute(phase_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
  }

  const size_t table = head > 0 ? head_table_words(M, batch) : 0;  // scratch: f, g, partials
  uint32_t* work_f = static_cast<uint32_t*>(scratch);
  uint32_t* work_g = work_f + table;
  uint32_t* partial = work_g + table;
  const size_t work_stride = (size_t)M / 4 * 3;  // elements a slot: M/2, then M/4
  const void* in_f = f;
  const void* in_g = g;
  int in_limbs = 1;
  size_t in_stride = (size_t)M;
  for (int r = 0; r < head; ++r) {
    const size_t half = (size_t)M >> (r + 1);
    const size_t region = (r % 2) ? (size_t)M / 2 * N : 0;  // words
    uint32_t* of = work_f + region;
    uint32_t* og = work_g + region;
    phase_head_kernel<<<dim3(head_blocks(half), batch), kHeadThreads, 0, st>>>(
        in_f, in_g, in_limbs, in_stride, of, og, work_stride, partial, r, head,
        static_cast<const int32_t*>(ch), half, fc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in_f = of;
    in_g = og;
    in_limbs = 0;
    in_stride = work_stride;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K * batch));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, phase_cluster_kernel, in_f, in_g, in_limbs, in_stride, m_tail,
                           head, (unsigned long long)M, partial, static_cast<const int32_t*>(ch),
                           static_cast<int32_t*>(msgs),
                           static_cast<int32_t*>(ff), static_cast<int32_t*>(fg), fc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// a, b: int32 [m, 16]; out: int32 [m, 16] = a b R^-1 by fr_mul_cc.
extern "C" int sczk_fr_mul_cc(const void* a, const void* b, void* out, int m, const void* consts,
                              void* stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  fr_mul_cc_kernel<<<(m + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), static_cast<int32_t*>(out),
      (unsigned)m, field_const<N>(static_cast<const uint32_t*>(consts)));
  return (int)cudaGetLastError();
}

// a: int32 [2, 16] (x, y); out: int32 [16] = x y^n R^-n, by fr_mul_cc
// (cc = 1) or fmul<8> (cc = 0) in one thread.
extern "C" int sczk_fr_mul_chain(const void* a, int n, int cc, void* out, const void* consts,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const FieldConst<N> fc = field_const<N>(static_cast<const uint32_t*>(consts));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cc) {
    fr_mul_chain_kernel<true><<<1, 1, 0, st>>>(static_cast<const int32_t*>(a), n,
                                                static_cast<int32_t*>(out), fc);
  } else {
    fr_mul_chain_kernel<false><<<1, 1, 0, st>>>(static_cast<const int32_t*>(a), n,
                                                 static_cast<int32_t*>(out), fc);
  }
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and static shared bytes per thread of
// kernel `which`: 0 the cluster kernel, 1 the head round.  out: int32 [3].
extern "C" int sczk_sumcheck_attrs(int which, int* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(&phase_cluster_kernel),
      reinterpret_cast<const void*>(&phase_head_kernel),
  };
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}
