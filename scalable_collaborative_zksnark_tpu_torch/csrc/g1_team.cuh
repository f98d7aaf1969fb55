// The G1 group law by dependency levels, run by a team of lanes of one
// warp (Hopper, sm_90a), on the low-latency Fq product of fq_chain.cuh.
//
// One thread running a point op of g1.cuh walks a chain of dependent Fq
// products, each about 2.1 us in a one-thread chain on an H100 (fr.cuh's
// fmul), and the G1 kernels have too few threads to hide that latency.
// Here a team of W lanes (W a power of two, 2 to 16) runs the op: at
// each dependency level lane k computes the level's k-th product with
// fq_mul_cc (about 0.9 us), and every lane reads each product from the
// lane that computed it by warp shuffle; a level wider than the team
// runs in rounds of W.  Every lane runs the same instructions on its own
// operands, so a round costs one product's latency:
//   general add (add-2007-bl), 16 products in 5 levels of at most 4:
//     Z1^2, Z2^2, Y1 Z2, Y2 Z1 | U1, S1, U2, S2 | H^2, (Z1 + Z2)^2 |
//     J, V, r2^2, Z3 | r2 (V - X3), S1 J
//   mixed add (madd-2007-bl), 11 products in 5 levels of at most 3:
//     Z1^2, Y2 Z1 | U2, S2 | H^2, Z1 H | J, V, r2^2 | r2 (V - X3), S1 J
//   double (dbl-2009-l), 7 products in 3 levels of at most 3:
//     X^2, Y^2, Y Z | B^2, (X + B)^2, E^2 | E (D - X3)
// The linear steps are computed by every lane on values all of them hold,
// so a team takes the infinity and x-collision branches as one.  Each
// team shuffles under its own lanes' mask, so the teams of one warp may
// take different branches.  Every field op returns the canonical value,
// so each result is bit-equal to the plain versions of curves/cuda_g1.py
// (and, for the general add and the double, to g1.cuh's g1_add and
// g1_double).
//
// fq_mul_cc wants canonical operands (a, b < p): every fadd/fsub output
// is canonical, and so is every point the kernels load.
#pragma once

#include <cstdint>

#include "fq_chain.cuh"
#include "g1.cuh"

// The group law of g1.cuh on fq_mul_cc (g1_add<FqMulCC>).
struct FqMulCC {
  __device__ __forceinline__ static void mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                             const FieldConst<NQ>& f) {
    fq_mul_cc(r, a, b, f);
  }
};

// This thread's place in its team: threads W k .. W k + W - 1 of a 1-D
// block form team k, so a team never straddles two warps.
template <int W>
struct Team {
  static_assert(W >= 2 && W <= 16 && (W & (W - 1)) == 0, "a team is 2 to 16 lanes of a warp");
  unsigned lane;  // 0 .. W - 1
  unsigned mask;  // the team's lanes in its warp, for __shfl_sync

  __device__ __forceinline__ static Team here() {
    const unsigned w = threadIdx.x % 32u;
    return {w % W, ((1u << W) - 1u) << (w - w % W)};
  }
};

// One product of a team level: r = a b.
struct Prod {
  const uint32_t* a;
  const uint32_t* b;
  uint32_t* r;
};

// The K independent products of one level, W at a time: in each round
// lane k computes the round's k-th product (lanes past the round's count
// repeat its first), then every lane reads each result from the lane that
// computed it.  Every lane must hold the same operands, and no product's
// result may be another's operand.
template <int K, int W>
__device__ __forceinline__ void team_level(const Prod (&ps)[K], const Team<W>& tm,
                                           const FieldConst<NQ>& f) {
#pragma unroll
  for (int r0 = 0; r0 < K; r0 += W) {
    const int n = K - r0 < W ? K - r0 : W;  // products in this round
    uint32_t x[NQ], y[NQ], p[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      x[j] = ps[r0].a[j];
      y[j] = ps[r0].b[j];
    }
#pragma unroll
    for (int k = 1; k < n; ++k) {
      const bool mine = tm.lane == (unsigned)k;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        x[j] = mine ? ps[r0 + k].a[j] : x[j];
        y[j] = mine ? ps[r0 + k].b[j] : y[j];
      }
    }
    fq_mul_cc(p, x, y, f);
#pragma unroll
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        ps[r0 + k].r[j] = n == 1 ? p[j] : __shfl_sync(tm.mask, p[j], k, W);
      }
    }
  }
}

// dbl-2009-l as g1_double, by levels; r may alias p.
template <int W>
__device__ __forceinline__ void team_double(Pt& r, const Pt& p, const G1Const& c,
                                            const Team<W>& tm) {
  const FieldConst<NQ>& f = c.f;
  const bool inf = fq_is_zero(p.z);
  uint32_t A[NQ], B[NQ], YZ[NQ], t[NQ], E[NQ], C[NQ], T2[NQ], G[NQ], D[NQ], u[NQ], Y3[NQ];
  team_level<3>({{p.x, p.x, A}, {p.y, p.y, B}, {p.y, p.z, YZ}}, tm, f);
  fadd<NQ>(t, p.x, B, f);
  fadd<NQ>(E, A, A, f);
  fadd<NQ>(E, E, A, f);  // E = 3A
  team_level<3>({{B, B, C}, {t, t, T2}, {E, E, G}}, tm, f);
  fsub<NQ>(D, T2, A, f);
  fsub<NQ>(D, D, C, f);
  fadd<NQ>(D, D, D, f);  // D = 2((X + B)^2 - A - C)
  fadd<NQ>(u, D, D, f);
  fsub<NQ>(r.x, G, u, f);  // X3 = E^2 - 2D
  fsub<NQ>(u, D, r.x, f);
  team_level<1>({{E, u, Y3}}, tm, f);
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

// Complete p1 + p2 by levels, as g1_add (add-2007-bl) or, with MIXED,
// madd-2007-bl for p2 with Z2 in {0, 1}.  Returns 1 when the sum was a doubling (an x-collision of
// equal points), else 0.  r may alias p1.
template <bool MIXED, int W>
__device__ __forceinline__ int team_add(Pt& r, const Pt& p1, const Pt& p2, const G1Const& c,
                                        const Team<W>& tm) {
  if (fq_is_zero(p1.z)) {
    r = p2;
    return 0;
  }
  if (fq_is_zero(p2.z)) {
    r = p1;
    return 0;
  }
  const FieldConst<NQ>& f = c.f;
  uint32_t Z1Z1[NQ], Z2Z2[NQ], YZ1[NQ], YZ2[NQ], U2[NQ], S2[NQ], U1g[NQ], S1g[NQ];
  const uint32_t* U1 = MIXED ? p1.x : U1g;  // mixed: U1 = X1, S1 = Y1
  const uint32_t* S1 = MIXED ? p1.y : S1g;
  if constexpr (MIXED) {
    team_level<2>({{p1.z, p1.z, Z1Z1}, {p2.y, p1.z, YZ2}}, tm, f);
    team_level<2>({{p2.x, Z1Z1, U2}, {YZ2, Z1Z1, S2}}, tm, f);
  } else {
    team_level<4>({{p1.z, p1.z, Z1Z1}, {p2.z, p2.z, Z2Z2}, {p1.y, p2.z, YZ1}, {p2.y, p1.z, YZ2}},
                  tm, f);
    team_level<4>({{p1.x, Z2Z2, U1g}, {YZ1, Z2Z2, S1g}, {p2.x, Z1Z1, U2}, {YZ2, Z1Z1, S2}}, tm,
                  f);
  }
  uint32_t H[NQ], R[NQ];
  fsub<NQ>(H, U2, U1, f);
  fsub<NQ>(R, S2, S1, f);
  if (fq_is_zero(H)) {
    if (fq_is_zero(R)) {
      team_double(r, p1, c, tm);
      return 1;
    }
    set_infinity(r, c);
    return 0;
  }
  uint32_t t[NQ], ZS[NQ], HH[NQ], Z3[NQ], I[NQ], J[NQ], V[NQ], R2[NQ], T[NQ], SJ[NQ];
  if constexpr (MIXED) {
    team_level<2>({{H, H, HH}, {p1.z, H, Z3}}, tm, f);
    fadd<NQ>(Z3, Z3, Z3, f);  // Z3 = 2 Z1 H
  } else {
    fadd<NQ>(ZS, p1.z, p2.z, f);
    team_level<2>({{H, H, HH}, {ZS, ZS, t}}, tm, f);
    fsub<NQ>(t, t, Z1Z1, f);
    fsub<NQ>(t, t, Z2Z2, f);  // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
  }
  fadd<NQ>(I, HH, HH, f);
  fadd<NQ>(I, I, I, f);  // I = 4 HH
  fadd<NQ>(R, R, R, f);  // r2 = 2r
  if constexpr (MIXED) {
    team_level<3>({{H, I, J}, {U1, I, V}, {R, R, R2}}, tm, f);
  } else {
    team_level<4>({{H, I, J}, {U1, I, V}, {R, R, R2}, {t, H, Z3}}, tm, f);  // Z3 = t H
  }
  fsub<NQ>(R2, R2, J, f);
  fadd<NQ>(t, V, V, f);
  fsub<NQ>(r.x, R2, t, f);  // X3 = r2^2 - J - 2V
  fsub<NQ>(t, V, r.x, f);
  team_level<2>({{R, t, T}, {S1, J, SJ}}, tm, f);
  fadd<NQ>(SJ, SJ, SJ, f);
  fsub<NQ>(r.y, T, SJ, f);  // Y3 = r2 (V - X3) - 2 S1 J
  fq_copy(r.z, Z3);
  return 0;
}

// Point i of `out` from the team, which holds it on every lane: lanes 0,
// 1 and 2 (mod W) store x, y and z.
template <int W>
__device__ __forceinline__ void team_store(const OutCoords& out, size_t i, const Pt& p,
                                           const Team<W>& tm) {
  if (tm.lane == 0) store_limbs<NQ>(out.x + i * (2 * NQ), p.x);
  if (tm.lane == 1 % W) store_limbs<NQ>(out.y + i * (2 * NQ), p.y);
  if (tm.lane == 2 % W) store_limbs<NQ>(out.z + i * (2 * NQ), p.z);
}
