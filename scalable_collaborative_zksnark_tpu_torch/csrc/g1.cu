// G1 point kernels for Hopper (sm_90a), on the team form of the group
// law (g1_team.cuh).
//
// Replaces curves/pallas_g1.py:
//   add_team_kernel      _add_kernel, op add (_point_call): a team of
//                        kAddTeam lanes per point;
//   point_op_team_kernel _add_kernel, op add_mixed, and _double_kernel:
//                        a team of kPointOpTeam lanes per point;
//   masked_op_team_kernel _add_masked_kernel and _add_reset_kernel (the
//                        same _point_call site): a mixed add under a
//                        per-point mask, a team of kMaskedTeam lanes per
//                        point;
//   accumulate_team_kernel _add_reset_lazy_kernel with the lax.scan over
//                        steps around it, the repair of flagged lanes and
//                        the joins of the buckets that cross lanes
//                        (primitives/msm.py _dense_bucket_sums), with
//   accumulate_team_kernel_join for the buckets that cross its blocks: a
//                        team of kScanTeam lanes per scan lane;
//   scalar_mul_team_kernel _scalar_mul_kernel: a team of kLadderTeam
//                        lanes per lane walks its MSB-first double-and-add
//                        ladder.
// _horner_kernel and _bucket_serial_kernel are g1_chain.cu's.  The TPU's
// VMEM tiling (lane padding, unroll) is not carried over; the
// recurrences and their add order are.
//
// What bounds them on this card.  Every kernel is a chain of dependent
// Fq products per thread (588 32-bit multiplies each).  With one thread
// a point on fmul (2.1 us a product in a one-thread chain) the general
// add took about 0.05 ms at every lane count of the prove up to 8,192
// (16 dependent products) and the masked add took 0.3-0.4 ms on 65,542 points against a byte bound
// of 0.014 ms: all held by the latency of one thread's chain, not by the
// card's multiply rate.  The scalar ladder most of all: the prove
// launches it on tens of lanes, so one thread's 256 doubles and about 128
// adds, some 3,800 dependent products at 2.1 us, took 9.3 ms a launch on
// one SM.  Its bound is that chain at the least time of one product: the
// depth of one CIOS product in dependent multiply-adds times one
// multiply-add's latency (imad_chain_kernel).
//
// What the team kernels do about it.  A team of lanes runs one point op
// by dependency levels on fq_mul_cc (g1_team.cuh), about 0.9 us a product
// instead of 2.1, a level of products in one product's latency.
// * add_team_kernel: kAddTeam = 4 lanes a point, so the general add takes
//   5 product latencies (16 products in levels of at most 4); 836 of the
//   prove's 854 adds are on 1 to 8,192 points, where that latency is the
//   time.  32 teams a block, neighbouring teams on
//   neighbouring points.  Every lane of a team loads both whole points
//   (the team's lanes read the same addresses, which the warp serves with
//   one request) and lanes 0, 1, 2 store x, y, z.  At 65,542 points a
//   2-lane team was faster in a probe on an H100 (fewer products repeated
//   on idle lanes), but the prove has only 4 adds that wide, so there is
//   one kernel.  160 registers, no spill.
// * point_op_team_kernel: add_mixed and double, neither launched on the
//   leader-mode prove, in the layout of add_team_kernel on kPointOpTeam =
//   2 lanes a point: the mixed add in 6 rounds (levels of 2, 2, 2, 3 and
//   2 products), the double in 5 (3, 3, 1).  At the size that times them,
//   65,542 points, they are bound by the products the lanes run, not by
//   one team's chain, and a 4-lane team repeats products on idle lanes
//   (20 lane-products a mixed add where 2 lanes run 12; 12 a double where
//   2 run 10).  In probes on an H100 (device time on 65,542 points) the
//   mixed add took 0.049 ms on 2 lanes, 0.073 on 4, 0.156 one thread a
//   point on fmul; the double 0.038 on 2 lanes, 0.052 on 4, 0.044 one
//   thread on fmul, against bounds of 0.025 and 0.016 ms by products.
// * accumulate_team_kernel and accumulate_team_kernel_join: the dense
//   MSM's bucket sums, kScanTeam = 2 lanes a scan lane.  The mixed add's
//   levels are 2, 2, 2, 3 and 2 products wide, so a 2-lane team runs it
//   in 6 rounds where a 4-lane team runs 5 with its third and fourth lanes
//   repeating products in four of them.  The walk takes as many lanes as
//   the card holds at once: the wrapper asks the runtime for the kernel's
//   occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor: 3 blocks of
//   4 warps an SM on an H100 at 167 registers, no spill) and multiplies by
//   the SMs, 25,344 lanes.  With 8,192 lanes, one warp a scheduler, a step
//   took one team's chain of dependent products and a base gather, about
//   9 us, and a full pass (2^22 entries) 4.97 ms; at three warps a
//   scheduler the chains overlap and the walk is held by the issue of its
//   instructions: 3.0 ms a full pass against 1.62 ms for its products'
//   multiply-adds alone (54%).  Lane t walks entries [t steps, (t + 1)
//   steps) of the key-sorted list, so the entries of one step lie `steps`
//   apart across lanes and their loads do not coalesce: each block (64
//   scan lanes) first stages its lanes' entries, kStageSteps steps at a
//   time, into shared memory as two words each (pid, neg, "same key as
//   the step before", "past E"; the key), the block's threads reading
//   keys, pid and neg contiguously.  Then each team walks its steps: the
//   base gather is one request a team, as in add_team_kernel; a reset
//   copies the point; an add is team_add<true>; an x-collision doubles in
//   the team and counts in `repaired`.  Nothing is stored a step: a run
//   of one key that ends inside a lane is its bucket's whole sum, written
//   to its slot.  The empty buckets' infinity is written by the whole
//   grid, each thread looking its buckets up in the sorted keys: the
//   lane that met the gap had written them one after another, and a
//   lane past a prove's small segments (a ragged MSM's, most of whose
//   2,049 buckets are empty) held every other back by about 1.4 ms.
//   What crosses lanes is joined on the card: each lane's first and last
//   run go through a segmented Hillis-Steele scan over the block's lanes
//   in the walk's epilogue (double-buffered in shared memory, one barrier
//   a round), and the one bucket a block that reaches back into the block
//   before, with each block's trailing chain, through the join kernel
//   (one block: a scan of each team's blocks, a Hillis-Steele scan over
//   the teams, then each head); 0.09 ms of a full pass's 3.1.  At most
//   log2(kScanLanes) + 1 + 2 g + log2(kJoinTeams) dependent general adds
//   join a bucket, g = ceil(blocks / kJoinTeams).  The teams of one warp
//   take resets, adds, padding and doublings apart from each other, which
//   their own shuffle masks allow.  Gathering each base a step ahead, to
//   overlap it with the add, was slower on an H100 at 8,192 lanes.
// * masked_op_team_kernel: kMaskedTeam = 2 lanes a point, the mixed add
//   in 6 rounds as in the accumulate.  Its launches cover a whole bucket
//   grid, [W, C 2^c] points, 33,024 to 536,640 in the non-dense prove, of
//   which each step masks 1 or 2 in a hundred: copying the others is most
//   of the work, and there a 4-lane team was no faster in a probe on an
//   H100, while on 65,542 points half masked it was slower.
//   128 threads a block, neighbouring teams on neighbouring points, so the
//   loads coalesce across teams; a team whose mask is 0 copies its operand.
// * scalar_mul_team_kernel: kLadderTeam = 4 lanes a lane, so a double
//   takes 3 rounds (levels 3, 3, 1) and a general add 5, where a 2-lane
//   team would take 5 and 8: the ladder has few lanes, so the rounds of
//   one team's chain are its time.  One warp (8 teams) a block, so that a
//   launch of a thousand lanes still spreads over the SMs.  Fixed windows
//   of kWindowBits = 4 bits over a table of 15 multiples of the point in
//   shared memory (built in one double and 13 adds): 256 doubles and at
//   most 64 adds a full-width scalar.  Bit by bit (256 doubles, about 128
//   adds) the teams of a warp split on nearly every bit, so the warp ran
//   the add at nearly every bit, 8 rounds a bit; a window's digit is 0 one
//   time in 16, so a warp's teams add together.  In a probe on an H100 the
//   windows were the faster at every shape of the prove.
// The output of each is bit-equal to its plain version (curves/cuda_g1.py),
// which follows the ladder's windows and the accumulate's joins step for
// step.
#include <cuda_runtime.h>

#include <cstdint>

#include "g1_team.cuh"

namespace {

constexpr long long kSentinel = 0xFFFFFFFFll;  // key of padding entries
constexpr int kAddTeam = 4;            // lanes a point of add_team_kernel
constexpr int kPointOpTeam = 2;        // lanes a point of point_op_team_kernel
constexpr int kScanTeam = 2;           // lanes a scan lane of accumulate_team_kernel
constexpr int kMaskedTeam = 2;         // lanes a point of masked_op_team_kernel
constexpr int kLadderTeam = 4;         // lanes a lane of scalar_mul_team_kernel
constexpr int kTeamThreads = 128;      // threads a block of the team kernels but the ladder
constexpr int kLadderThreads = 32;     // one warp a block: a ladder of few lanes spreads over the SMs
constexpr int kWindowBits = 4;         // bits a window of the ladder (cuda_g1.LADDER_WINDOW)
constexpr int kWindowSize = 1 << kWindowBits;
static_assert(16 % kWindowBits == 0, "a window lies within one 16-bit scalar limb");
constexpr unsigned kScanLanes = kTeamThreads / kScanTeam;
constexpr unsigned kStageSteps = 64;             // accumulate steps staged at a time
constexpr unsigned kStagePitch = kStageSteps + 1;  // odd: a warp's teams read different banks
// a staged accumulate entry: pid in the low bits, then flags
constexpr uint32_t kEntryValid = 1u << 31;  // e < E (else padding: infinity)
constexpr uint32_t kEntrySame = 1u << 30;   // key == the previous step's key
constexpr uint32_t kEntryNeg = 1u << 29;    // negate the base's y
constexpr uint32_t kEntryPid = kEntryNeg - 1u;
constexpr unsigned kJoinTeams = 128;  // teams of accumulate_team_kernel_join
constexpr unsigned kJoinThreads = kJoinTeams * kScanTeam;

// out[i] = a[i] + b[i], one team of kAddTeam lanes per point.
__global__ void __launch_bounds__(kTeamThreads)
    add_team_kernel(Coords a, Coords b, OutCoords out, unsigned m, G1Const c) {
  const Team<kAddTeam> tm = Team<kAddTeam>::here();
  const unsigned i = (blockIdx.x * blockDim.x + threadIdx.x) / kAddTeam;
  if (i >= m) return;  // the whole team
  Pt p, q, r;
  load_point(a, i, p);
  load_point(b, i, q);
  team_add<false>(r, p, q, c, tm);
  team_store(out, i, r, tm);
}

// out[i] = a[i] + b[i] with b[i] affine or infinity (OP 1, add_mixed), or
// 2 a[i] (OP 2, double; b unused), one team of kPointOpTeam lanes per
// point.
template <int OP>
__global__ void __launch_bounds__(kTeamThreads)
    point_op_team_kernel(Coords a, Coords b, OutCoords out, unsigned m, G1Const c) {
  const Team<kPointOpTeam> tm = Team<kPointOpTeam>::here();
  const unsigned i = (blockIdx.x * blockDim.x + threadIdx.x) / kPointOpTeam;
  if (i >= m) return;  // the whole team
  Pt p, r;
  load_point(a, i, p);
  if (OP == 2) {
    team_double(r, p, c, tm);
  } else {
    Pt q;
    load_point(b, i, q);
    team_add<true>(r, p, q, c, tm);
  }
  team_store(out, i, r, tm);
}

// OP: 0 add_masked (out = mask ? a + b : a, the bucket accumulate step of
// the non-dense MSM cores), 1 add_reset (out = mask ? a + b : b); b is
// affine or infinity (mixed add).  One team of kMaskedTeam lanes per
// point: where the mask is set the team runs team_add<true>; where it is
// 0 the team does no arithmetic and copies its operand, as the TPU's
// select would return it.  The mask is one byte a point, so a team never
// splits on it; the teams of one warp may.
template <int OP>
__global__ void __launch_bounds__(kTeamThreads)
    masked_op_team_kernel(Coords a, Coords b, const uint8_t* __restrict__ mask, OutCoords out,
                          unsigned m, G1Const c) {
  const Team<kMaskedTeam> tm = Team<kMaskedTeam>::here();
  const unsigned i = (blockIdx.x * blockDim.x + threadIdx.x) / kMaskedTeam;
  if (i >= m) return;  // the whole team
  Pt p;
  if (mask[i]) {
    Pt q;
    load_point(a, i, p);
    load_point(b, i, q);
    team_add<true>(p, p, q, c, tm);
  } else {
    load_point(OP == 0 ? a : b, i, p);
  }
  team_store(out, i, p, tm);
}

// p into a team's slot in shared memory: lanes 0, 1 and 2 (mod W) write
// x, y and z, as team_store does.
template <int W>
__device__ __forceinline__ void team_put(Pt& slot, const Pt& p, const Team<W>& tm) {
  if (tm.lane == 0) fq_copy(slot.x, p.x);
  if (tm.lane == 1 % W) fq_copy(slot.y, p.y);
  if (tm.lane == 2 % W) fq_copy(slot.z, p.z);
}

// Infinity, (0, 1, 0), into point i of `out`, stored as team_store does.
template <int W>
__device__ __forceinline__ void team_store_infinity(const OutCoords& out, size_t i,
                                                    const G1Const& c, const Team<W>& tm) {
  uint32_t zero[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) zero[j] = 0u;
  if (tm.lane == 0) store_limbs<NQ>(out.x + i * (2 * NQ), zero);
  if (tm.lane == 1 % W) store_limbs<NQ>(out.y + i * (2 * NQ), c.one);
  if (tm.lane == 2 % W) store_limbs<NQ>(out.z + i * (2 * NQ), zero);
}

// Whether an entry of the key-sorted list has key k: a binary search.
__device__ __forceinline__ bool has_key(const int64_t* __restrict__ keys, long long E,
                                        long long k) {
  long long lo = 0, hi = E;  // the first entry of key >= k lies in [lo, hi]
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < E && keys[lo] == k;
}

// Key of entry e of the list, kSentinel past its end.
__device__ __forceinline__ long long key_at(const int64_t* __restrict__ keys, long long E,
                                            long long e) {
  return e < E ? keys[e] : kSentinel;
}

// Entry e of the list as the accumulate stages it; `first` is set at a
// lane's first step, where the previous key is kSentinel.
__device__ __forceinline__ uint32_t entry_word(const int64_t* __restrict__ keys,
                                               const int64_t* __restrict__ pid,
                                               const uint8_t* __restrict__ neg, long long E,
                                               long long e, bool first) {
  const long long k = key_at(keys, E, e);
  const long long prev = first ? kSentinel : key_at(keys, E, e - 1);
  uint32_t w = k == prev ? kEntrySame : 0u;
  if (e < E) w |= kEntryValid | (neg[e] ? kEntryNeg : 0u) | (uint32_t)pid[e];
  return w;
}

// Bucket `key` of the output: p, or infinity where its digit is 0 (key %
// K == 0); padding (key >= NB) writes nothing.
template <int W>
__device__ __forceinline__ void put_bucket(const OutCoords& out, long long key, const Pt& p,
                                           unsigned NB, unsigned K, const G1Const& c,
                                           const Team<W>& tm) {
  if (key >= (long long)NB) return;
  if (key % K == 0) {
    team_store_infinity(out, (size_t)key, c, tm);
  } else {
    team_store(out, (size_t)key, p, tm);
  }
}

// Shared memory of a walk block: the staged chunk of entries, which the
// join of the block's lanes reuses once the walk is done, and each lane's
// first run.
struct WalkStage {
  uint32_t word[kScanLanes * kStagePitch];
  uint32_t key[kScanLanes * kStagePitch];
};
struct WalkScan {  // two of each: a round writes one while the last may still be read
  Pt v[2][kScanLanes];
  uint32_t wh[2][kScanLanes];
};
struct WalkShared {
  union {
    WalkStage stage;
    WalkScan scan;
  } u;
  Pt lead[kScanLanes];
  uint32_t head;
};

// The dense MSM's bucket sums from a key-sorted entry list: out[k] = the
// sum of the entries of key k (entry e is P = bases[pid[e]], negated
// where neg is set), infinity where no entry has key k or k % K == 0.
// Lane t walks entries [t steps, (t + 1) steps): acc = (key == previous
// key) ? acc + P : P, a mixed add that doubles in the team on an
// x-collision (counted in `repaired`); entries past E are padding (key
// kSentinel, P = infinity).  The grid's threads first write infinity
// to the buckets no entry has, a binary search of the keys each.  A run
// of one key that ends inside the lane and did not begin at its first
// step is a whole bucket: the lane writes it.  What is left lies across
// lanes: each lane's first run (its lead) and last (its trail; the same
// run where the lane holds one key).  The block
// joins them in its epilogue: a segmented Hillis-Steele scan over its
// lanes in shared memory gives v, the sum of the chain of trails of one
// key that ends at the lane (a lane holding one key that continues the
// lane before joins that lane's chain; log2(kScanLanes) rounds).  A lane
// writes its trail where the next lane does not continue it, and its
// lead's bucket (the lead plus the chain ending at the lane before) where
// that bucket ends in the lane, unless the chain reaches back into the
// block before: that one bucket a block (the head) and the block's own
// trailing chain go to accumulate_team_kernel_join through `tails`,
// `heads` and `meta` (see there).  One team of kScanTeam lanes per scan
// lane, kScanLanes lanes a block.
__global__ void __launch_bounds__(kTeamThreads)
    accumulate_team_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ pid,
                           const uint8_t* __restrict__ neg, long long E, Coords bases,
                           unsigned T, unsigned steps, unsigned NB, unsigned K, OutCoords out,
                           OutCoords tails, OutCoords heads, uint32_t* meta, int* repaired,
                           G1Const c) {
  __shared__ WalkShared sh;
  const Team<kScanTeam> tm = Team<kScanTeam>::here();
  const unsigned lane0 = blockIdx.x * kScanLanes;
  const unsigned lanes = min(kScanLanes, T - lane0);
  const unsigned tl = threadIdx.x / kScanTeam, t = lane0 + tl;
  const bool live = tl < lanes;
  uint32_t zero[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) zero[j] = 0u;
  // the buckets no entry has are infinity; the whole grid's threads look
  // them up (a bucket with entries is written by the lane or join it ends in)
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < NB;
       k += (long long)gridDim.x * blockDim.x) {
    if (!has_key(keys, E, k)) {
      store_limbs<NQ>(out.x + k * (2 * NQ), zero);
      store_limbs<NQ>(out.y + k * (2 * NQ), c.one);
      store_limbs<NQ>(out.z + k * (2 * NQ), zero);
    }
  }
  Pt acc, p;
  set_infinity(acc, c);
  int rep = 0;
  long long cur = kSentinel;  // the key of the run acc holds
  bool led = false;           // the lane's first run has ended (its sum in sh.lead)
  if (threadIdx.x == 0) sh.head = 0u;
  for (unsigned s0 = 0; s0 < steps; s0 += kStageSteps) {
    const unsigned n = min(kStageSteps, steps - s0);
    __syncthreads();  // every team is done with the last chunk
    for (unsigned j = threadIdx.x; j < lanes * n; j += blockDim.x) {
      const unsigned l = j / n, s = j % n;
      const long long e = (long long)(lane0 + l) * steps + s0 + s;
      sh.u.stage.word[l * kStagePitch + s] = entry_word(keys, pid, neg, E, e, s0 + s == 0);
      sh.u.stage.key[l * kStagePitch + s] = (uint32_t)key_at(keys, E, e);
    }
    __syncthreads();
    if (!live) continue;
    for (unsigned s = 0; s < n; ++s) {
      const uint32_t w = sh.u.stage.word[tl * kStagePitch + s];
      if (w & kEntryValid) {
        load_point(bases, w & kEntryPid, p);
        if (w & kEntryNeg) fsub<NQ>(p.y, zero, p.y, c.f);
      } else {
        set_infinity(p, c);
      }
      if (w & kEntrySame) {
        rep += team_add<true>(acc, acc, p, c, tm);
      } else {
        if (s0 + s > 0) {  // the run of key cur ended at the step before
          if (led) {
            put_bucket(out, cur, acc, NB, K, c, tm);
          } else {
            team_put(sh.lead[tl], acc, tm);
            led = true;
          }
        }
        acc = p;
        cur = sh.u.stage.key[tl * kStagePitch + s];
      }
    }
  }
  __syncthreads();  // the walk is done: the staging area becomes the scan's
  // acc is the lane's trail, of key cur; its lead is the same run unless led
  const long long e0 = (long long)t * steps, e1 = e0 + steps;
  const long long first = key_at(keys, E, e0);
  const long long before = e0 > 0 ? key_at(keys, E, e0 - 1) : -1;
  const bool uni = !led;
  const bool cl = live && e0 > 0 && before == first;  // the lead continues the lane before
  const bool cr = live && t + 1 < T && key_at(keys, E, e1) == cur;  // the next lane continues the trail
  // wh: every lane from the block's first to this one holds one key and
  // continues the lane before
  bool wh = uni && cl;
  unsigned r = 0;  // rounds so far; round r reads and writes buffer r & 1
  for (unsigned d = 1; d < lanes; d <<= 1, ++r) {
    if (live) {
      team_put(sh.u.scan.v[r & 1][tl], acc, tm);
      if (tm.lane == 0) sh.u.scan.wh[r & 1][tl] = wh;
    }
    __syncthreads();
    if (live && tl >= d && wh) {
      rep += team_add<false>(acc, sh.u.scan.v[r & 1][tl - d], acc, c, tm);
      wh = sh.u.scan.wh[r & 1][tl - d] != 0u;
    }
  }
  const Pt* v = sh.u.scan.v[r & 1];  // the chains, and below which lanes reach the block's first
  const uint32_t* whs = sh.u.scan.wh[r & 1];
  if (live) {
    team_put(sh.u.scan.v[r & 1][tl], acc, tm);
    if (tm.lane == 0) sh.u.scan.wh[r & 1][tl] = wh;
  }
  __syncthreads();
  const unsigned b = blockIdx.x;
  if (live && tl + 1 == lanes) {  // the block's trailing chain
    team_store(tails, b, acc, tm);
    if (tm.lane == 0) meta[3 * b + 2] = wh;
  }
  if (live && !uni && !cr) put_bucket(out, cur, acc, NB, K, c, tm);
  // the lead's bucket: a lane holding one key has it in its chain; else
  // the lead, after the chain ending at the lane before where it continues
  const bool head = cl && (tl == 0 || whs[tl - 1] != 0u);
  if (live && !uni) {
    if (tl > 0 && cl) {
      rep += team_add<false>(acc, v[tl - 1], sh.lead[tl], c, tm);
    } else {
      acc = sh.lead[tl];
    }
  }
  if (live && !(uni && cr)) {  // the lead's bucket ends in this lane
    if (head && first < (long long)NB && first % K != 0) {
      team_store(heads, b, acc, tm);
      if (tm.lane == 0) sh.head = 1u;
    } else {
      put_bucket(out, first, acc, NB, K, c, tm);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // lane 0's first key is the block's
    meta[3 * b] = (uint32_t)first;
    meta[3 * b + 1] = sh.head;
  }
  if (tm.lane == 0 && rep) atomicAdd(repaired, rep);
}

// The buckets that cross the walk's blocks, one block of kJoinTeams teams
// over the G blocks' entries: tails[j] (block j's trailing chain),
// meta[3 j + 2] (block j holds one key and continues block j - 1's trail)
// and meta[3 j + 1] (a bucket of key meta[3 j] began before block j and
// ends in it; its part in block j is heads[j]).  Team q owns blocks [q g,
// q g + g), g = ceil(G / kJoinTeams).  It scans its blocks' tails in
// order (A_j = A_{j-1} + tails[j] where block j continues the one before,
// else tails[j]; written back over tails[j]); a segmented Hillis-Steele
// scan over the teams' last A in shared memory gives P_q, the chain
// ending at team q's last block.  The chain ending at block j - 1 is
// A_{j-1}, after P_{q-1} where every block of the team up to j - 1
// continues the one before (P_{q-1} alone at the team's first block);
// block j's head bucket is that chain plus heads[j].  At most 2 g +
// log2(teams) dependent adds.
__global__ void __launch_bounds__(kJoinThreads)
    accumulate_team_kernel_join(unsigned G, OutCoords tails, Coords heads,
                                const uint32_t* __restrict__ meta, OutCoords out, int* repaired,
                                G1Const c) {
  __shared__ Pt pv[2][kJoinTeams];  // two of each, as in the walk's scan
  __shared__ uint32_t pw[2][kJoinTeams];
  const Team<kScanTeam> tm = Team<kScanTeam>::here();
  const unsigned q = threadIdx.x / kScanTeam;
  const unsigned g = (G + kJoinTeams - 1) / kJoinTeams, teams = (G + g - 1) / g;
  const bool live = q < teams;
  const unsigned j0 = q * g, j1 = min(G, j0 + g);
  const Coords scanned = {tails.x, tails.y, tails.z};
  Pt acc, p;
  int rep = 0;
  bool wh = true;  // every block of the team continues the block before
  if (live) {
    for (unsigned j = j0; j < j1; ++j) {
      const bool link = meta[3 * j + 2] != 0u;
      load_point(scanned, j, p);
      if (j > j0 && link) {
        rep += team_add<false>(acc, acc, p, c, tm);
        team_store(tails, j, acc, tm);
      } else {
        acc = p;
      }
      wh = wh && link;
    }
  }
  unsigned r = 0;
  for (unsigned d = 1; d < teams; d <<= 1, ++r) {
    if (live) {
      team_put(pv[r & 1][q], acc, tm);
      if (tm.lane == 0) pw[r & 1][q] = wh;
    }
    __syncthreads();
    if (live && q >= d && wh) {
      rep += team_add<false>(acc, pv[r & 1][q - d], acc, c, tm);
      wh = pw[r & 1][q - d] != 0u;
    }
  }
  const Pt* P = pv[r & 1];
  if (live) team_put(pv[r & 1][q], acc, tm);
  __syncthreads();  // also shows each team's A_j in tails to both its lanes
  if (live) {  // block 0 has no head, nor does a block after it in team 0 reach P_{-1}
    bool reach = true;  // every block of the team before j continues the one before it
    for (unsigned j = j0; j < j1; ++j) {
      if (meta[3 * j + 1]) {
        if (j == j0) {
          acc = P[q - 1];
        } else {
          load_point(scanned, j - 1, acc);
          if (reach) rep += team_add<false>(acc, P[q - 1], acc, c, tm);
        }
        load_point(heads, j, p);
        rep += team_add<false>(acc, acc, p, c, tm);
        team_store(out, meta[3 * j], acc, tm);
      }
      reach = reach && meta[3 * j + 2] != 0u;
    }
  }
  if (tm.lane == 0 && rep) atomicAdd(repaired, rep);
}

// out[i] = scalar_i pts[i], one team of kLadderTeam lanes per lane, by
// fixed windows of kWindowBits bits, MSB first, on the plain version's
// schedule step for step: the team builds its table T_k = k P (T_1 = P,
// T_2 = 2P, T_k = T_{k-1} + P) in shared memory, then for each window
// doubles acc kWindowBits times (from infinity) and adds T_digit where
// the window's digit is not 0.  scalars: n_limbs 16-bit limbs per lane,
// standard form, least significant first.  Every lane of a team reads the
// same scalar word, so a team never splits on a digit; the teams of one
// warp may.  The bound of one block an SM lets ptxas take the registers
// the kernel needs: without it ptxas held it to 168 and spilled.
__global__ void __launch_bounds__(kLadderThreads, 1)
    scalar_mul_team_kernel(Coords pts, const int32_t* __restrict__ scalars, int n_limbs,
                           unsigned m, OutCoords out, G1Const c) {
  constexpr int kTeams = kLadderThreads / kLadderTeam;
  __shared__ Pt table[kTeams][kWindowSize];  // entry 0 unused
  const Team<kLadderTeam> tm = Team<kLadderTeam>::here();
  const unsigned t = threadIdx.x / kLadderTeam, i = blockIdx.x * kTeams + t;
  if (i >= m) return;  // the whole team
  Pt* tab = table[t];
  {
    Pt P, cur;
    load_point(pts, i, P);
    team_put(tab[1], P, tm);
    team_double(cur, P, c, tm);
    team_put(tab[2], cur, tm);
#pragma unroll 1
    for (int k = 3; k < kWindowSize; ++k) {
      team_add<false>(cur, cur, P, c, tm);
      team_put(tab[k], cur, tm);
    }
  }
  __syncwarp(tm.mask);  // the table, from every lane of the team
  Pt acc;
  set_infinity(acc, c);
  const int32_t* sc = scalars + (size_t)i * n_limbs;
#pragma unroll 1
  for (int l = n_limbs - 1; l >= 0; --l) {
    const uint32_t w = (uint32_t)sc[l];
#pragma unroll 1
    for (int b = 16 - kWindowBits; b >= 0; b -= kWindowBits) {
#pragma unroll 1
      for (int d = 0; d < kWindowBits; ++d) team_double(acc, acc, c, tm);
      const uint32_t digit = (w >> b) & (kWindowSize - 1u);
      if (digit) team_add<false>(acc, acc, tab[digit], c, tm);
    }
  }
  team_store(out, i, acc, tm);
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

// blocks of `threads` for `teams` teams of `width` lanes
unsigned team_blocks(long long teams, int width, int threads = kTeamThreads) {
  return (unsigned)((teams * width + threads - 1) / threads);
}

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
  const unsigned nb = team_blocks(m, op == 0 ? kAddTeam : kPointOpTeam);
  if (op == 0) {
    add_team_kernel<<<nb, kTeamThreads, 0, s>>>(a, b, o, (unsigned)m, c);
  } else if (op == 1) {
    point_op_team_kernel<1><<<nb, kTeamThreads, 0, s>>>(a, b, o, (unsigned)m, c);
  } else {
    point_op_team_kernel<2><<<nb, kTeamThreads, 0, s>>>(a, b, o, (unsigned)m, c);
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
  const unsigned nb = team_blocks(m, kMaskedTeam);
  if (op == 0) {
    masked_op_team_kernel<0><<<nb, kTeamThreads, 0, s>>>(a, b, mk, o, (unsigned)m, c);
  } else {
    masked_op_team_kernel<1><<<nb, kTeamThreads, 0, s>>>(a, b, mk, o, (unsigned)m, c);
  }
  return (int)cudaGetLastError();
}

// keys, pid: int64 [E] (keys ascending, below NB); neg: uint8 [E];
// bases: the point table pid indexes (fewer than 2^29 points); T lanes of
// ceil(E / T) steps; out: [NB] bucket sums; scratch: [2 G] points and
// meta: uint32 [3 G] for G = ceil(T / kScanLanes) blocks; repaired: one
// int32, incremented.  One launch of the walk, and one of the join where
// G > 1.
extern "C" int sczk_g1_accumulate(const void* keys, const void* pid, const void* neg, long long E,
                                  const void* bx, const void* by, const void* bz, int T, int NB,
                                  int K, void* ox, void* oy, void* oz, void* sx, void* sy, void* sz,
                                  void* meta, void* repaired, const void* consts, void* stream) {
  if (T <= 0 || E <= 0 || NB <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const unsigned G = (unsigned)((T + kScanLanes - 1) / kScanLanes);
  const long long steps = (E + T - 1) / T;
  auto s = static_cast<cudaStream_t>(stream);
  const OutCoords scratch = out_coords(sx, sy, sz);
  const OutCoords tails = scratch;
  const OutCoords heads = {scratch.x + (size_t)G * 2 * NQ, scratch.y + (size_t)G * 2 * NQ,
                           scratch.z + (size_t)G * 2 * NQ};
  const OutCoords out = out_coords(ox, oy, oz);
  const G1Const c = consts_of(consts);
  auto* m = static_cast<uint32_t*>(meta);
  auto* rep = static_cast<int*>(repaired);
  accumulate_team_kernel<<<G, kTeamThreads, 0, s>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(pid),
      static_cast<const uint8_t*>(neg), E, coords(bx, by, bz), (unsigned)T, (unsigned)steps,
      (unsigned)NB, (unsigned)K, out, tails, heads, m, rep, c);
  if (G > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    accumulate_team_kernel_join<<<1, kJoinThreads, 0, s>>>(
        G, tails, Coords{heads.x, heads.y, heads.z}, m, out, rep, c);
  }
  return (int)cudaGetLastError();
}

// out: int32 [3]: the walk's scan lanes resident on every SM of the
// current device at once (blocks an SM at the kernel's occupancy times
// the SMs times kScanLanes), the blocks an SM and the SMs.
extern "C" int sczk_g1_accumulate_lanes(int* out) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, accumulate_team_kernel,
                                                        kTeamThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks * sms * (int)kScanLanes;
  out[1] = blocks;
  out[2] = sms;
  return 0;
}

// scalars: int32 [m, n_limbs] standard-form 16-bit limbs.
extern "C" int sczk_g1_scalar_mul(const void* px, const void* py, const void* pz,
                                  const void* scalars, int n_limbs, int m, void* ox, void* oy,
                                  void* oz, const void* consts, void* stream) {
  if (m <= 0 || n_limbs <= 0) return (int)cudaErrorInvalidValue;
  scalar_mul_team_kernel<<<team_blocks(m, kLadderTeam, kLadderThreads), kLadderThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      coords(px, py, pz), static_cast<const int32_t*>(scalars), n_limbs, (unsigned)m,
      out_coords(ox, oy, oz), consts_of(consts));
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
// 0 add, 1 add_mixed, 2 double, 3 accumulate (the walk), 4 scalar_mul,
// 5 add_masked, 6 add_reset, 7 the accumulate's join (Horner and
// bucket-serial: g1_chain.cu).
// out: int32 [2].
extern "C" int sczk_g1_attrs(int which, int* out) {
  const void* fns[] = {
      reinterpret_cast<const void*>(&add_team_kernel),
      reinterpret_cast<const void*>(&point_op_team_kernel<1>),
      reinterpret_cast<const void*>(&point_op_team_kernel<2>),
      reinterpret_cast<const void*>(&accumulate_team_kernel),
      reinterpret_cast<const void*>(&scalar_mul_team_kernel),
      reinterpret_cast<const void*>(&masked_op_team_kernel<0>),
      reinterpret_cast<const void*>(&masked_op_team_kernel<1>),
      reinterpret_cast<const void*>(&accumulate_team_kernel_join),
  };
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}
