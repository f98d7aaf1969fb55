"""Multilinear-KZG ("cube") polynomial commitment: local, c_ and d_ ops.

Mirrors the JAX package's ``primitives/poly_comm.py`` (parity:
dist-primitive/src/dpoly_comm.rs):

* SRS ``powers_of_g[k]`` = the 2^k tensor products of (1 - s_j, s_j) over
  the *last* k variables (dpoly_comm.rs:37-67); ``powers_of_g2`` =
  [g2, g2^{s_0}, ...] as host points;
* ``commit`` = MSM(powers_of_g[k], evals); ``open`` = n rounds of
  (q_i = hi - lo, fold), all q commitments in one ``msm_ragged``;
  ``verify`` = e(C - v g, g2) == prod_i e(pi_i, g2^{s_i} - u_i g2), on
  the host pairing of ``curves/host_curve.py``;
* ``c_commit`` = one ragged d_msm over *packed* SRS share points;
  ``c_open`` = local share rounds, one batched c_commit, pss2ss, log2(l)
  tiny MSMs in one ladder;
* ``d_commit`` / ``d_open`` = party-sliced evals, local MSM or open, a
  leader sum and a root open.

The JAX package's documented deviation (honest distributed SRS: party p's
slice of level k is w_p * level_{k - log N}, so local results are scaled
by w_p and root levels serve the leader rounds) is kept.  Every gather and
scatter is counted as the JAX package counts it, call for call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..curves import host_curve as hc
from ..curves.g1 import Curve, PointJ, map_points
from ..mpc.net import VEC_PREFIX, PartyNet
from ..pss.pss import PackedSharingParams
from ..utils.timer import spanned
from .msm import _dmsm_prescale, _dmsm_scale_consts, msm, msm_ragged
from .unpack import pss2ss


def _cat(pts, dim: int) -> PointJ:
    return map_points(lambda *a: torch.cat(a, dim=dim), *pts)


def _stack(pts, dim: int) -> PointJ:
    return map_points(lambda *a: torch.stack(a, dim=dim), *pts)


def _fold_rounds(F, cur: torch.Tensor, point, start: int, count: int):
    """``count`` rounds of q = hi - lo, cur = lo + point[start + i] * q
    over axis -2: (q list, folded table)."""
    qs = []
    for i in range(count):
        half = cur.shape[-2] // 2
        lo, hi = cur[..., :half, :], cur[..., half:, :]
        q = F.sub(hi, lo)
        qs.append(q)
        cur = F.add(lo, F.mul(point[start + i], q))
    return qs, cur


@dataclasses.dataclass
class PolynomialCommitment:
    """Device SRS + host G2 powers for one max size 2^n."""

    curve: Curve
    powers_of_g: List[PointJ]  # level k: PointJ [2^k]
    powers_of_g2: List[tuple]  # host G2 affine points (n + 1 of them)
    # distributed extension: [N] object ints or {m_total: [N]} (honest SRS)
    party_weights: Optional[object] = None
    root_levels: Optional[object] = None  # [PointJ ...] or {m_total: [PointJ ...]}
    # packed SRS share points per level: [N, 2^k/l] (srs_packed) or flat
    # [2^k/l] party-invariant points (srs_random)
    packed_powers: Optional[List[PointJ]] = None
    # every stored level normalized (z in {0, 1}): MSMs skip their inversion
    affine: bool = False
    # the party of row 0 of the per-party packed levels (a process's rows
    # start at its first party once they were cut on the host: shard_srs)
    packed_offset: int = 0

    def normalized(self) -> "PolynomialCommitment":
        """One batch normalization of every stored G1 level."""
        cv = self.curve

        def norm_lv(lvs):
            if lvs is None:
                return None
            if isinstance(lvs, dict):
                return {k: [cv.normalize(p) for p in v] for k, v in lvs.items()}
            return [cv.normalize(p) for p in lvs]

        return dataclasses.replace(
            self, powers_of_g=norm_lv(self.powers_of_g), root_levels=norm_lv(self.root_levels),
            packed_powers=norm_lv(self.packed_powers), affine=True)

    # ------------------------------------------------------------------
    @spanned("pcs")
    def commit(self, peval: torch.Tensor, c: int = 8) -> PointJ:
        """evals [..., 2^k, L] (Montgomery) -> commitment point(s) [...]."""
        k = peval.shape[-2].bit_length() - 1
        return msm(self.curve, self.powers_of_g[k], self.curve.fr.decode(peval), c=c,
                   affine=self.affine)

    def _fold_q(self, peval: torch.Tensor, point: torch.Tensor, start: int):
        """Shared opening fold: (q list per round, final value [..., L])."""
        n = peval.shape[-2].bit_length() - 1
        qs, cur = _fold_rounds(self.curve.fr, peval, point, start, n)
        return qs, cur[..., 0, :]

    @spanned("pcs")
    def open(self, peval: torch.Tensor, point: torch.Tensor, c: int = 8):
        """-> (value [..., L], proofs: list of n PointJ [...]); round i
        commits q_i at level n - 1 - i, all rounds in one ``msm_ragged``."""
        F = self.curve.fr
        qs, value = self._fold_q(peval, point, 0)
        bases = [self.powers_of_g[q.shape[-2].bit_length() - 1] for q in qs]
        return value, msm_ragged(self.curve, bases, [F.decode(q) for q in qs],
                                 affine=self.affine)

    def verify(self, commitment: PointJ, value, proofs, point_ints, g2_offset: int = 0) -> bool:
        """Pairing check on the host (BLS12-381 only).  ``commitment`` and
        ``proofs`` are single points; ``value`` and ``point_ints`` Python
        ints.  Level k of an n-variable SRS tensors the trailing variables,
        so a sub-level opening pairs proof i with g2^{s_{offset+i}},
        offset = n - k."""
        one = lambda pt: self.curve.to_affine_ints(map_points(lambda a: a[None], pt))[0]  # noqa: E731
        g1aff = one(map_points(lambda a: a[0], self.powers_of_g[0]))
        lhs_pt = hc.g1_add(one(commitment), hc.g1_neg(hc.g1_mul(g1aff, value)))
        g2 = self.powers_of_g2[0]
        pairs = [(lhs_pt, g2)]
        for i, pi in enumerate(proofs):
            rhs_g2 = hc.g2_add(self.powers_of_g2[g2_offset + i + 1],
                               hc.g2_neg(hc.g2_mul(g2, point_ints[i])))
            pairs.append((hc.g1_neg(one(pi)), rhs_g2))
        return hc.pairing_product_is_one(pairs)

    # ------------------------------------------------------------------
    # Distributed (d_) ops: evals sliced 1/N per party, party axis first
    # ------------------------------------------------------------------
    def _weights_for(self, m_total: int):
        w = self.party_weights
        return w[m_total] if isinstance(w, dict) else w

    def _root_levels_for(self, m_total: int):
        rl = self.root_levels
        return rl[m_total] if isinstance(rl, dict) else rl

    def _scale_by_weights(self, net: PartyNet, pts: PointJ, m_total: int) -> PointJ:
        """Party p's point(s) times w_p, the prefix-tensor factor of an
        m_total-variable polynomial; ``pts`` [P, ...]."""
        w = self._weights_for(m_total)[net.party_slice]
        P = net.local_parties
        if all(int(wp) == 1 for wp in w):
            return pts  # random benchmark SRS: every weight is 1
        scal = np.asarray([int(wp) for wp in w], dtype=object).reshape(
            (P,) + (1,) * (pts.x.ndim - 2))
        return self.curve.scalar_mul_int(pts, scal)

    @spanned("pcs")
    def d_commit(self, net: PartyNet, peval: torch.Tensor, c: int = 8) -> PointJ:
        """peval [P, ..., M_loc, L] -> the commitment(s) [P, ...]; extra
        batch dims share the one leader round."""
        k = peval.shape[-2].bit_length() - 1
        B = math.prod(peval.shape[1:-2])
        local = msm(self.curve, self.powers_of_g[k], self.curve.fr.decode(peval), c=c,
                    affine=self.affine)
        local = self._scale_by_weights(net, local, k + net.n.bit_length() - 1)
        total = self.curve.sum(net.gather_to_root(local, "g1", count=B, vec=B > 1), axis=0)
        out = map_points(lambda a: a[None].expand((net.n,) + a.shape), total)
        return net.scatter_from_root(out, "g1", count=B, vec=B > 1)

    def _root_open(self, net: PartyNet, local_z: torch.Tensor, point, s: int):
        """The leader's fold of the N gathered local values over point[:s]:
        (root q list, value [..., L])."""
        cur = net.gather_data_only(local_z).movedim(0, -2)  # [..., N, L]
        qs, cur = _fold_rounds(self.curve.fr, cur, point, 0, s)
        return qs, cur[..., 0, :]

    def _open_bytes(self, net: PartyNet, B: int, m_points: int) -> int:
        return B * (net.payload_bytes("fr", 1) + VEC_PREFIX + net.payload_bytes("g1", m_points))

    @spanned("pcs")
    def d_open_many(self, net: PartyNet, items, c: int = 8):
        """k distributed opens in two ragged MSM passes (all local q-vectors,
        then all root q-vectors); bytes and outputs as k ``d_open`` calls.
        ``items``: list of (peval [P, B..., 2^m, L], point [n, L]) with one
        leading batch shape."""
        F = self.curve.fr
        s = net.n.bit_length() - 1
        plans, bases_all, qs_all = [], [], []
        for peval, point in items:
            m = peval.shape[-2].bit_length() - 1
            qs, local_z = self._fold_q(peval, point, s)
            plans.append((point, m, math.prod(peval.shape[1:-2]), local_z, len(qs)))
            bases_all += [self.powers_of_g[q.shape[-2].bit_length() - 1] for q in qs]
            qs_all += [F.decode(q) for q in qs]
        pis_flat = msm_ragged(self.curve, bases_all, qs_all, affine=self.affine)

        outs, root_jobs, k = [], [], 0
        for point, m, B, local_z, nq in plans:
            local_pis = [self._scale_by_weights(net, pi, m + s) for pi in pis_flat[k:k + nq]]
            k += nq
            net._count_gather(self._open_bytes(net, B, m))
            summed = [self.curve.sum(net.gather_data_only(p_), axis=0) for p_ in local_pis]
            root_qs, value = self._root_open(net, local_z, point, s)
            rl = self._root_levels_for(m + s)
            root_jobs.append(([rl[q.shape[-2].bit_length() - 1] for q in root_qs],
                              [F.decode(q) for q in root_qs]))
            net._count_scatter(self._open_bytes(net, B, s + m))
            outs.append((value, summed))
        rb = [b for bs, _ in root_jobs for b in bs]
        rq = [q for _, qs_ in root_jobs for q in qs_]
        root_flat = msm_ragged(self.curve, rb, rq, affine=self.affine) if rb else []
        final, k = [], 0
        for (value, summed), (bs, _) in zip(outs, root_jobs):
            final.append((value, root_flat[k:k + len(bs)] + summed))
            k += len(bs)
        return final

    @spanned("pcs")
    def d_open(self, net: PartyNet, peval: torch.Tensor, point: torch.Tensor, c: int = 8):
        """peval [P, ..., 2^m, L], point [n, L] -> (value [..., L], proofs).

        Parties fold their slice with point[s:]; the leader sums their
        round proofs, then opens the root polynomial of the N local values
        over point[:s] with the root levels.  Proof order: root rounds,
        then local rounds (verify's slot order, dpoly_comm.rs:466-484)."""
        F = self.curve.fr
        s = net.n.bit_length() - 1
        m = peval.shape[-2].bit_length() - 1
        B = math.prod(peval.shape[1:-2])
        qs, local_z = self._fold_q(peval, point, s)
        bases = [self.powers_of_g[q.shape[-2].bit_length() - 1] for q in qs]
        pis = msm_ragged(self.curve, bases, [F.decode(q) for q in qs], affine=self.affine)
        local_pis = [self._scale_by_weights(net, pi, m + s) for pi in pis]
        # one leader round: each worker pushes (z, Vec<pi>) per slot
        net._count_gather(self._open_bytes(net, B, m))
        summed = [self.curve.sum(net.gather_data_only(p_), axis=0) for p_ in local_pis]
        root_qs, value = self._root_open(net, local_z, point, s)
        rl = self._root_levels_for(m + s)
        root_pis = (msm_ragged(self.curve, [rl[q.shape[-2].bit_length() - 1] for q in root_qs],
                               [F.decode(q) for q in root_qs], affine=self.affine)
                    if root_qs else [])
        # the leader scatters the answer (dpoly_comm.rs:386-391)
        net._count_scatter(self._open_bytes(net, B, s + m))
        return value, root_pis + summed


# ---------------------------------------------------------------------------
# SRS constructors
# ---------------------------------------------------------------------------
def _tensor_scalars(F, factors) -> List[torch.Tensor]:
    """The scalars of the tensor levels, as Fr tensors on ``F``'s device:
    level 0 is [1], level i + 1 is (1 - f_i) level i followed by f_i level
    i (dpoly_comm.rs:37-67's order of the factors)."""
    r = F.p
    levels = [F.const(1, (1,))]
    for f in factors:
        f %= r
        prev = levels[-1]
        levels.append(torch.cat([F.mul(F.const((1 - f) % r), prev), F.mul(F.const(f), prev)],
                                dim=-2))
    return levels


def _ladder_levels(curve: Curve, g1_aff, scalar_levels) -> List[PointJ]:
    """g1 times every scalar of ``scalar_levels`` (Montgomery Fr tensors
    [..., L] of any batch shapes): one ladder launch from the fixed
    generator over all of them, one batch normalization, split back."""
    F = curve.fr
    flat = torch.cat([w.reshape(-1, F.L) for w in scalar_levels], dim=0)
    g = curve.from_affine_ints([g1_aff])
    pts = curve.normalize(curve.scalar_mul(g, F.decode(flat)))
    out, off = [], 0
    for w in scalar_levels:
        m = math.prod(w.shape[:-1])
        out.append(map_points(lambda a, o=off, m=m, shp=w.shape[:-1]: a[o:o + m].reshape(
            shp + a.shape[-1:]), pts))
        off += m
    return out


def _packed_scalars(F, pp: PackedSharingParams, w: torch.Tensor) -> torch.Tensor:
    """A level's scalars [2^k, L] (zero-padded to l) packed per party:
    [n, max(2^k / l, 1), L], share j of chunk c = sum_i M[j, i] w[c l + i]."""
    sz = w.shape[-2]
    if sz < pp.l:
        w = torch.cat([w, F.zeros((pp.l - sz,))], dim=-2)
    chunks = w.reshape(-1, pp.l, F.L)  # [C, l]
    mt = F.array_from_ints(pp.pack_matrix().T)  # [l, n]
    acc = None
    for i in range(pp.l):
        term = F.mul(chunks[:, i, None, :], mt[i])  # [C, n]
        acc = term if acc is None else F.add(acc, term)
    return acc.movedim(0, 1)


def srs_from_secret(curve: Curve, g1_aff, g2_aff, s_ints, n_parties: int = 1,
                    pp: Optional[PackedSharingParams] = None):
    """Exact SRS from a (test) secret vector s (``PolynomialCommitmentCub::new``,
    dpoly_comm.rs:37-67), built on ``curve``'s device: each level's scalars
    are Fr tensor products of the factors s_i and 1 - s_i, and every point
    is one ladder from ``g1_aff`` (all levels in one launch).  With
    n_parties > 1 also the honest distributed extension, keyed by the
    committed polynomial's total variable count m_total (its party-prefix
    variables are s_ints[n - m_total .. n - m_total + log2 N]); the party
    weights are host ints.  With ``pp`` also ``packed_powers``, the points
    of ``srs_packed(srs, pp)`` packed from the same scalars: share j of
    chunk c is (sum_i M[j, i] w[c l + i]) g1, one ladder a (chunk, party)
    in the same launch."""
    n = len(s_ints)
    F = curve.fr
    r = F.p
    scalars = _tensor_scalars(F, [s_ints[n - i - 1] for i in range(n)])
    powers_of_g2 = [g2_aff] + [hc.g2_mul(g2_aff, si % r) for si in s_ints]
    party_weights, root_scalars = None, {}
    if n_parties > 1:
        sbits = n_parties.bit_length() - 1
        party_weights = {}
        for m_total in range(sbits, n + 1):
            base = n - m_total
            w_arr = np.empty((n_parties,), dtype=object)
            for p in range(n_parties):
                w = 1
                for i in range(sbits):
                    f = s_ints[base + i] % r
                    w = w * (f if (p >> (sbits - 1 - i)) & 1 else (1 - f) % r) % r
                w_arr[p] = w
            party_weights[m_total] = w_arr
            root_scalars[m_total] = _tensor_scalars(
                F, [s_ints[base + sbits - i - 1] for i in range(sbits)])[:sbits]
    packed = [] if pp is None else [_packed_scalars(F, pp, w) for w in scalars]
    pts = _ladder_levels(curve, g1_aff, scalars + [w for lv in root_scalars.values() for w in lv]
                         + packed)
    rest = iter(pts[n + 1:])
    root_levels = {k: [next(rest) for _ in lv] for k, lv in root_scalars.items()} or None
    return PolynomialCommitment(curve, pts[:n + 1], powers_of_g2, party_weights, root_levels,
                                packed_powers=list(rest) or None, affine=True)


def srs_ugly(curve: Curve, g1_aff, g2_aff, s_ints, party_count: int):
    """The reference's ``new_ugly`` (dpoly_comm.rs:69-113): the first
    log2(party_count) levels tensor over s[log_party - 1], ..., s[0], then
    the standard factors s[n - i - 1]; built on the device as
    ``srs_from_secret``.  Value-inconsistent by construction, like the
    reference's: it is size- and cost-faithful only."""
    n = len(s_ints)
    log_party = party_count.bit_length() - 1
    if party_count != 1 << log_party:
        raise ValueError(f"party count {party_count} is not a power of two")
    factors = [s_ints[log_party - i - 1] if i < log_party else s_ints[n - i - 1] for i in range(n)]
    powers_of_g = _ladder_levels(curve, g1_aff, _tensor_scalars(curve.fr, factors))
    powers_of_g2 = [g2_aff] + [hc.g2_mul(g2_aff, si % curve.fr.p) for si in s_ints]
    return PolynomialCommitment(curve, powers_of_g, powers_of_g2, affine=True)


def srs_packed(srs: PolynomialCommitment, pp: PackedSharingParams) -> PolynomialCommitment:
    """The SRS points packed into PSS shares per party (``to_packed``,
    dpoly_comm.rs:164-194), levels shorter than l padded with infinity
    first: ``packed_powers[k]`` is PointJ [N, max(2^k / l, 1)].  An SRS
    from known secrets packs faster from its scalars
    (``srs_from_secret(..., pp=pp)``)."""
    curve = srs.curve
    packed = []
    for lv in srs.powers_of_g:
        sz = lv.x.shape[0]
        if sz < pp.l:
            lv = _cat([lv, curve.infinity((pp.l - sz,))], 0)
        chunks = map_points(lambda a: a.reshape(max(sz // pp.l, 1), pp.l, a.shape[-1]), lv)
        shares = pp.pack_from_public_group(curve, chunks)  # [chunks, n]
        lvl = map_points(lambda a: a.movedim(-2, 0), shares)  # [n, chunks]
        packed.append(curve.normalize(lvl) if srs.affine else lvl)
    return dataclasses.replace(srs, packed_powers=packed)


def rand_points_flat(curve: Curve, count: int, seed: int) -> PointJ:
    """``count`` structure-free valid G1 points, normalized: G times seeded
    2-limb scalars on two small ladders (O(sqrt(count)) lanes), then one
    outer add A_i + B_j over all lanes (the JAX package's recipe and seeds)."""
    if count == 0:
        return curve.infinity((0,))
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    side = min(max(int(np.ceil(np.sqrt(count))), 1), 4096)
    rows = (count + side - 1) // side
    ka = rng.randint(1, 1 << 16, size=(side, 2)).astype(np.int32)
    kb = rng.randint(1, 1 << 16, size=(rows, 2)).astype(np.int32)
    g = curve.from_affine_ints([hc.G1_GEN])
    A = curve.scalar_mul(g, torch.from_numpy(ka).to(curve.device))  # [side]
    B = curve.scalar_mul(g, torch.from_numpy(kb).to(curve.device))  # [rows]
    grid = curve.add(map_points(lambda a: a[None], A), map_points(lambda a: a[:, None], B))
    return curve.normalize(map_points(lambda a: a.reshape(rows * side, -1)[:count], grid))


def _rand_levels(curve: Curve, sizes, seed: int) -> List[PointJ]:
    """Random points for all levels from one flat generation, sliced."""
    flat = rand_points_flat(curve, sum(sizes), seed)
    offs = np.cumsum([0] + list(sizes))
    return [map_points(lambda a, o=int(o), n=n: a[o:o + n], flat) for o, n in zip(offs, sizes)]


def srs_random(curve: Curve, n: int, seed: int, n_parties: int = 1, packed_parties: int = 0,
               max_level: int | None = None) -> PolynomialCommitment:
    """Benchmark SRS with random points (``new_toy`` / ``new_single`` /
    ``new_random``, dpoly_comm.rs:115-233): structure-free, size- and
    cost-faithful, party weights all 1.  ``packed_parties`` > 0 also fills
    ``packed_powers`` with flat party-invariant share points of 2^k / l;
    ``max_level`` caps the unpacked levels (``new_random``'s truncation,
    dpoly_comm.rs:222).  Every level is normalized already."""
    top = n if max_level is None else min(max_level, n)
    powers = _rand_levels(curve, [1 << k for k in range(top + 1)], seed)
    g2s = [hc.G2_GEN] + [hc.g2_mul(hc.G2_GEN, seed * 7919 + i + 1) for i in range(n)]
    out = PolynomialCommitment(curve, powers, g2s, affine=True)
    if n_parties > 1:
        out.party_weights = np.asarray([1] * n_parties, dtype=object)
        out.root_levels = _rand_levels(curve, [1 << j for j in range(n_parties.bit_length() - 1)],
                                       seed + 101)
    if packed_parties:
        l = packed_parties // 8
        out.packed_powers = _rand_levels(curve, [max((1 << k) // l, 1) for k in range(n + 1)],
                                         seed + 211)
    return out


# ---------------------------------------------------------------------------
# Collaborative (c_) ops on PSS shares
# ---------------------------------------------------------------------------
def _d_msm_ragged(curve: Curve, pp: PackedSharingParams, net: PartyNet, bases_list,
                  scalars_list, affine: bool = False, round_batches=None) -> PointJ:
    """d_msm over a ragged batch: one ``msm_ragged`` for every entry, the
    rank-1 leader reduce (dmsm.rs:29-40) folded into the scalars.
    ``round_batches``: entries per logical round for the byte accounting
    (default: one round).  Returns PointJ [P, ..., B]."""
    scaled = [_dmsm_prescale(pp, net, s) for s in scalars_list]
    locs = msm_ragged(curve, bases_list, scaled, affine=affine)  # [P, ...] each
    local = _stack(locs, -2)  # [P, ..., B]
    B = len(locs) * math.prod(locs[0].x.shape[1:-1])
    round_batches = [B] if round_batches is None else round_batches
    if sum(round_batches) != B:
        raise ValueError(f"round batches {round_batches} do not add up to {B}")
    for rb in round_batches:
        net._count_gather(net.payload_bytes("g1", rb, vec=True))
    if net.mode == "leader":
        for rb in round_batches:
            net._count_scatter(net.payload_bytes("g1", rb, vec=True))
        return local
    t = curve.sum(net.gather_data_only(local), axis=0)  # [..., B] = w . x
    # the root scatters q_j (w . x) to party j: each process scales its rows
    q = net.party_rows(curve.fr._tensor(_dmsm_scale_consts(pp)[2]))
    tb = map_points(lambda a: a[None].expand(q.shape[:1] + a.shape), t)
    out = curve.scalar_mul(tb, q.reshape(q.shape[:1] + (1,) * (tb.x.ndim - 2) + q.shape[-1:]))
    for rb in round_batches:
        net._count_scatter(net.payload_bytes("g1", rb, vec=True))
    return out


def _tiny_msm_rounds(curve: Curve, bases_list, scals_list) -> List[PointJ]:
    """The log2(l) phase-2 proof MSMs of a c_open in one ladder launch:
    every round's (base, q) pairs concatenated into one ``scalar_mul``,
    then a tree sum per round.  ``scals_list[i]``: [..., S_i, L] standard
    form; ``bases_list[i]`` broadcastable to the same batch (prefixes
    align, as in ``msm``)."""
    sizes = [s.shape[-2] for s in scals_list]
    qcat = torch.cat(scals_list, dim=-2)  # [..., S, L]
    bcat = _cat(bases_list, -2)
    pb, sb = bcat.x.shape[:-2], qcat.shape[:-2]
    if len(sb) > len(pb):
        bcat = map_points(lambda a: a.reshape(pb + (1,) * (len(sb) - len(pb)) + a.shape[-2:]),
                          bcat)
    prods = curve.scalar_mul(bcat, qcat)  # [..., S]
    offs = np.cumsum([0] + sizes)
    return [curve.sum(map_points(lambda a, o=int(o), n=n: a[..., o:o + n, :], prods), axis=-1)
            for o, n in zip(offs, sizes)]


def party_packed_levels(levels, net: PartyNet) -> list:
    """Packed SRS levels with the per-party ones ([N, M] points: three
    arrays or tensors [N, M, 24]) cut to the net's rows; flat levels
    ([M], the same for every party) as they are."""
    out = []
    for pt in levels:
        if pt[0].ndim == 3:
            if pt[0].shape[0] != net.n:
                raise ValueError(f"a packed level of {pt[0].shape[0]} parties for a net of {net.n}")
            rows = [a[net.party_slice] for a in pt]
            pt = PointJ(*rows) if isinstance(pt, PointJ) else tuple(rows)
        out.append(pt)
    return out


def _packed_base(srs: PolynomialCommitment, pp: PackedSharingParams, net: PartyNet,
                 entries: int) -> PointJ:
    """The packed SRS level of a share vector of ``entries``: per-party
    levels ([N, M], srs_packed, or the rows cut on the host, which start at
    party ``packed_offset``) give the net's parties' rows; flat
    ones ([M], srs_random) broadcast downstream."""
    b = srs.packed_powers[(entries * pp.l).bit_length() - 1]
    if b.x.ndim == 3:
        lo = net.party_offset - srs.packed_offset
        b = map_points(lambda a: a[lo:lo + net.local_parties], b)
    return b


@spanned("pcs")
def c_commit(srs: PolynomialCommitment, pp: PackedSharingParams, net: PartyNet,
             pevals: list, c: int = 8) -> PointJ:
    """Batched collaborative commit (dpoly_comm.rs:244-267): share tables
    [P, M_k, L] -> PointJ [P, B], shares of the commitments."""
    F = srs.curve.fr
    bases = [_packed_base(srs, pp, net, pe.shape[-2]) for pe in pevals]
    return _d_msm_ragged(srs.curve, pp, net, bases, [F.decode(pe) for pe in pevals],
                         affine=srs.affine)


def _phase2(srs, pp, net, ss: torch.Tensor, challenges):
    """The log2(l) local rounds after pss2ss: (folded table, proofs list
    from ``_tiny_msm_rounds``).  ``challenges(i)`` gives round i's
    challenge, broadcastable to the table's batch."""
    F = srs.curve.fr
    cur2, q2, b2 = ss, [], []
    for i in range(pp.l.bit_length() - 1):
        half = cur2.shape[-2] // 2
        lo, hi = cur2[..., :half, :], cur2[..., half:, :]
        q = F.sub(hi, lo)
        q2.append(F.decode(q))
        b2.append(_packed_base(srs, pp, net, q.shape[-2]))
        cur2 = F.add(lo, F.mul(challenges(i), q))
    return cur2, (_tiny_msm_rounds(srs.curve, b2, q2) if q2 else [])


@spanned("pcs")
def c_open(srs: PolynomialCommitment, pp: PackedSharingParams, net: PartyNet,
           peval: torch.Tensor, point: torch.Tensor, c: int = 8):
    """Collaborative open (dpoly_comm.rs:401-464): n_loc local share
    rounds, one batched c_commit of their q-vectors, pss2ss, and log2(l)
    local rounds whose proof MSMs share one ladder.  Phase 2 continues at
    point[n_loc:] (the JAX package's deviation; the reference reuses
    point[i]).  Returns (value share [P, ..., L], proofs [P, ..., n_loc +
    log2(l)])."""
    n_loc = peval.shape[-2].bit_length() - 1
    qs, cur = _fold_rounds(srs.curve.fr, peval, point, 0, n_loc)
    com_shares = c_commit(srs, pp, net, qs, c=c)  # [P, ..., n_loc]
    ss = pss2ss(pp, net, cur[..., 0, :])  # [P, ..., l, L]
    cur2, extra = _phase2(srs, pp, net, ss, lambda i: point[n_loc + i])
    proofs = _cat([com_shares, _stack(extra, -2)], -2) if extra else com_shares
    return cur2[..., 0, :], proofs


@spanned("pcs")
def c_open_many(srs: PolynomialCommitment, pp: PackedSharingParams, net: PartyNet,
                items, c: int = 8):
    """k collaborative opens of same-size tables on one compute path: one
    ragged d_msm for every q-vector, one pss2ss for all finals, shared
    phase-2 rounds; bytes and rounds as k ``c_open`` calls.  ``items``:
    list of (peval [P, M, L], point [n, L]).  Returns [(value [P, L],
    proofs [P, R])]."""
    F = srs.curve.fr
    bases_all, scals_all, plans = [], [], []
    for peval, point in items:
        if peval.ndim != 3:
            raise ValueError("c_open_many takes [P, M, L] tables (no extra batch dims)")
        n_loc = peval.shape[-2].bit_length() - 1
        qs, cur = _fold_rounds(F, peval, point, 0, n_loc)
        bases_all += [_packed_base(srs, pp, net, q.shape[-2]) for q in qs]
        scals_all += [F.decode(q) for q in qs]
        plans.append((point, n_loc, cur[..., 0, :]))
    com_flat = _d_msm_ragged(srs.curve, pp, net, bases_all, scals_all, affine=srs.affine,
                             round_batches=[n_loc for _, n_loc, _ in plans])  # [P, sum n_loc]

    # one pss2ss for all finals, counted per item
    for _ in plans:
        net._count_gather(net.payload_bytes("fr", 1))
    ss = pss2ss(pp, net, torch.stack([z for _, _, z in plans], dim=-2), count=False)  # [P, k, l, L]
    for _ in plans:
        net._count_scatter(net.payload_bytes("fr", pp.l, vec=True))

    ch = lambda i: torch.stack([point[n_loc + i] for point, n_loc, _ in plans])[None, :, None]  # noqa: E731
    cur2, extra = _phase2(srs, pp, net, ss, ch)  # extra: each [P, k]
    outs, off = [], 0
    for idx, (_, n_loc, _) in enumerate(plans):
        proofs = map_points(lambda a, o=off, n=n_loc: a[..., o:o + n, :], com_flat)
        off += n_loc
        if extra:
            proofs = _cat([proofs, _stack([map_points(lambda a: a[..., idx, :], x)
                                           for x in extra], -2)], -2)
        outs.append((cur2[..., idx, 0, :], proofs))
    return outs
