"""Multi-scalar multiplication: the dense signed-digit Pippenger, the
non-dense bucket cores, and d_msm.

Mirrors the JAX package's ``primitives/msm.py``.  Its default path (dense
core, signed digits, cost-model window width) is this module's default;
``SCZK_MSM_DENSE=0``, read at call time as the JAX package reads it,
selects the non-dense cores instead (``_msm_ragged_core``, and
``_msm_1d_buckets`` on it): unsigned digits, one key sort per window, and
a loop over the largest bucket's length in which every (window, chunk,
bucket) lane does one ``Curve.add_mixed_masked`` (the ``add_masked``
kernel); ``msm_ragged`` then splits segments into chunks of at most 4,096
points and sums the chunk partials.  Per window of c
bits, every (window, entry) pair becomes one entry of a globally
key-sorted list (key = window, segment, digit); ``cuda_g1.accumulate``
walks that list in T lanes, one mixed add per entry, and a log2(T)-step
segmented scan over the lane summaries carries buckets that cross lanes.
Bucket sums are weighted (sum_k k*B_k) by ``cuda_g1.bucket_serial`` when
there are at least ``SERIAL_REDUCE_MIN_LANES`` (window, segment) lanes,
else by a prefix scan and a tree sum, and windows are combined by
``cuda_g1.horner``.  Up to ``NAIVE_MAX`` points an MSM is a batched
double-and-add and a tree sum.

Differences from the JAX package, none of which changes a value:
* ``SCZK_MSM_DENSE`` is the one ``SCZK_*`` switch: the dense core always
  uses signed digits and the cost-model c (``_msm_1d_dense``, the flat
  entry of the JAX package's oracle tests, takes a fixed c);
* no ``MIN_MSM_SIZE`` zero padding (it bounded XLA compiles);
* the non-dense ``msm`` runs its batch as chunks of one bucket grid (the
  JAX package vmaps ``_msm_1d``; the masked steps past an instance's
  largest bucket change nothing);
* negating the point of a negative digit (``_negate_where``) happens
  inside the accumulate, which gathers each entry's base itself instead
  of taking a materialised list of gathered points;
* an x-collision doubles inside the accumulate, so there is no lazy flag
  and no repair pass;
* ``jax.lax.sort_key_val`` is ``torch.sort(stable=True)`` on int64 keys
  (the padding key 0xFFFFFFFF would sort first as int32).

``d_msm``: the reference's leader map (gather, unpack2, sum, re-pack;
dmsm.rs:29-40) is rank 1, so its scalar factors are folded into the MSM
scalars by group linearity, exactly as the JAX package does.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from ..curves import cuda_g1
from ..curves.g1 import Curve, PointJ, map_points
from ..fields.config import LIMB_BITS, int_to_limbs
from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams

NAIVE_MAX = 256
"""Up to this many points an MSM is one batched double-and-add and a tree sum."""

DENSE_LANES = 8192
"""Lanes of the dense accumulation: each walks E/T entries of the sorted list."""

SERIAL_REDUCE_MIN_LANES = 192
"""(window, segment) lanes from which the weighted bucket reduce runs the
bucket-serial kernel instead of the prefix scan (the JAX package's gate)."""

MAX_DENSE_ENTRIES = 1 << 22
"""Entries E = W*N of one dense pass; beyond it the windows run in chunks."""

RAGGED_CHUNK = 4096
"""Largest chunk of a segment in the non-dense ``msm_ragged``: the bucket
loop runs as many steps as the fullest bucket of any chunk holds."""


def _dense_enabled() -> bool:
    """The dense core, unless ``SCZK_MSM_DENSE`` is set to 0 (read at each
    call, as the JAX package's ``_dense_enabled``)."""
    return os.environ.get("SCZK_MSM_DENSE", "1") != "0"


def _digit(scalars: torch.Tensor, c: int, w: int) -> torch.Tensor:
    """Window-w base-2^c digit of each scalar (int64 [N, L] limbs -> [N])."""
    bitpos = w * c
    limb, off = divmod(bitpos, LIMB_BITS)
    L = scalars.shape[-1]
    val = scalars[..., min(limb, L - 1)] >> off
    if off > 0 and limb + 1 < L:
        val = val | (scalars[..., limb + 1] << (LIMB_BITS - off))
    return val & ((1 << c) - 1)


def _signed_digit_block(scalars: torch.Tensor, c: int, ws, carry: torch.Tensor):
    """Signed digits of ascending windows ``ws`` given the carry into the
    first: (magnitudes [wc, N], negative [wc, N], carry out [N]).

    d = raw + carry; if d > 2^(c-1): d -= 2^c and carry 1.  Magnitudes lie
    in [0, 2^(c-1)]; scalars below 2^255 never carry out of the top window."""
    half, full = 1 << (c - 1), 1 << c
    mags, negs = [], []
    for w in ws:
        d = _digit(scalars, c, w) + carry
        neg = d > half
        carry = neg.to(torch.int64)
        mags.append(torch.where(neg, full - d, d))
        negs.append(neg)
    return torch.stack(mags), torch.stack(negs), carry


def _horner_windows(curve: Curve, totals: PointJ, c: int) -> PointJ:
    """res = sum_w 2^(c*w) totals[w]: [W, C...] -> [C...], one kernel launch."""
    W, batch = totals.x.shape[0], totals.x.shape[1:-1]
    flat = map_points(lambda a: a.reshape(W, math.prod(batch), a.shape[-1]), totals)
    out = cuda_g1.horner(curve.fq.spec, flat, c)
    return PointJ(*(a.reshape(batch + a.shape[-1:]) for a in out))


def _prefix_scan_axis1(curve: Curve, pts: PointJ, axis: int = 1) -> PointJ:
    """Inclusive prefix point-sum along a batch axis (Hillis-Steele)."""
    n = pts.x.shape[axis]
    batch_ndim = pts.x.ndim - 1
    idx = torch.arange(n, device=pts.x.device).reshape(
        (1,) * axis + (n,) + (1,) * (batch_ndim - axis - 1))
    p = pts
    for k in range(max((n - 1).bit_length(), 1)):
        sh = 1 << k
        p_sh = map_points(lambda a: torch.roll(a, sh, dims=axis), p)
        p = curve.select((idx >= sh).expand(p.x.shape[:-1]), curve.add(p, p_sh), p)
    return p


def _weighted_bucket_totals(curve: Curve, acc_wck: PointJ) -> PointJ:
    """sum_{k>=1} k*B_k per (window, segment): [W, C, K] -> [W, C].

    With W*C >= SERIAL_REDUCE_MIN_LANES the bucket-serial kernel runs the
    running suffix (2(K-2) adds on W*C lanes); below it a reversed prefix
    scan and a tree sum of the suffixes (about 2 log2(K) adds on W*C*K
    lanes) keep more lanes busy."""
    W, C, K = acc_wck.x.shape[:3]
    if W * C >= SERIAL_REDUCE_MIN_LANES:
        flat = map_points(lambda t: t.movedim(2, 0).reshape(K, W * C, t.shape[-1]), acc_wck)
        out = cuda_g1.bucket_serial(curve.fq.spec, flat)
        return PointJ(*(t.reshape(W, C, t.shape[-1]) for t in out))
    rev = map_points(lambda t: t.flip(2), acc_wck)
    pref = _prefix_scan_axis1(curve, rev, axis=2)
    return curve.sum(map_points(lambda t: t[:, :, : K - 1], pref), axis=2)


def _dense_bucket_sums(curve: Curve, bases: PointJ, pid: torch.Tensor, neg: torch.Tensor,
                       keys: torch.Tensor, ends_g: torch.Tensor, starts_g: torch.Tensor,
                       lens: torch.Tensor, T: int = DENSE_LANES) -> PointJ:
    """Bucket sums from a globally key-sorted entry list.

    Entry e is ``bases[pid[e]]`` (affine, z in {0, 1}), negated where
    ``neg[e]``; ``keys`` [E] int64 ascending; ``ends_g`` / ``starts_g`` /
    ``lens`` [NB]: global end (exclusive), start and length per bucket.
    Returns PointJ [NB], infinity for an empty bucket."""
    E = keys.shape[0]
    # the cross-lane scan costs ~log2(T) adds on T lanes whatever E is:
    # keep at least ~32 steps per lane, and no fewer than 512 lanes
    if E < 32 * T:
        T = max(512, 1 << max(E // 32, 1).bit_length() - 1)
    T = min(T, E)
    steps = -(-E // T)
    scanned, _ = cuda_g1.accumulate(curve.fq.spec, keys, pid, neg, bases, T, steps)
    scanned = PointJ(*scanned)  # [steps, T]
    pad = torch.full((steps * T - E,), cuda_g1.SENTINEL, dtype=keys.dtype, device=keys.device)
    keys_lt = torch.cat([keys, pad]).reshape(T, steps).T

    # lane summaries: trailing-run sum, first and last key, key-uniform lane
    first_key, last_key = keys_lt[0], keys_lt[-1]
    val = map_points(lambda a: a[-1], scanned)
    fk, wh = first_key, first_key == last_key
    idx = torch.arange(T, device=keys.device)
    for step in range(max((T - 1).bit_length(), 1)):
        # Hillis-Steele over blocks of lanes: a block's last key is always
        # its rightmost lane's, so ``last_key`` serves at every distance;
        # the right block's trailing run extends into the left block iff
        # the right block is uniform and the keys meet at the boundary
        sh = 1 << step
        val_l = map_points(lambda a: torch.roll(a, sh, 0), val)
        ok = idx >= sh
        join = ok & wh & (torch.roll(last_key, sh, 0) == fk)
        val = curve.select(join, curve.add(val, val_l), val)
        fk = torch.where(join, torch.roll(fk, sh, 0), fk)
        wh = torch.where(ok, join & torch.roll(wh, sh, 0), wh)

    # bucket = scanned value at its last entry (+ the previous lane's run
    # when the bucket started there)
    e = (ends_g - 1).clamp(min=0)
    lane, pos = e // steps, e % steps
    v_end = map_points(lambda a: a[pos, lane], scanned)
    prev_lane = (lane - 1).clamp(min=0)
    carry = map_points(lambda a: a[prev_lane], val)
    key_e = keys[e.clamp(max=E - 1)]
    need_carry = ((lane > 0) & (starts_g < lane * steps)
                  & (last_key[prev_lane] == key_e) & (first_key[lane] == key_e))
    total = curve.select(need_carry, curve.add(v_end, carry), v_end)
    return curve.select(lens > 0, total, curve.infinity(lens.shape))


def _pick_c_dense(total_n: int, n_segments: int, nbits: int = 256) -> int:
    """Window width by the JAX package's cost model: W*total_n mixed adds
    of accumulation plus the weighted reduce of the branch the lane gate
    will take; bucket grids above 2^21 points are skipped."""
    best_c, best_cost = 4, None
    for c in (2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13):
        W = -(-nbits // c)
        K = (1 << (c - 1)) + 1
        if W * n_segments * K > (1 << 21):
            continue
        if W * n_segments >= SERIAL_REDUCE_MIN_LANES:
            red = 3.4 * W * n_segments * K
        else:
            red = 1.3 * W * n_segments * K * c
        cost = W * total_n + red
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def _msm_ragged_dense(curve: Curve, points: PointJ, scalars_std: torch.Tensor, sizes: tuple,
                      c: int, affine: bool) -> PointJ:
    """Segmented MSM: points [N], scalars [N, L] split into consecutive
    segments of ``sizes``; returns PointJ [len(sizes)].  Windows run in
    chunks when W*N exceeds MAX_DENSE_ENTRIES (bucket sums are per window,
    so only the signed-digit carry crosses chunks)."""
    N = scalars_std.shape[0]
    dev = scalars_std.device
    K = (1 << (c - 1)) + 1
    C = len(sizes)
    W = -(-scalars_std.shape[-1] * LIMB_BITS // c)
    aff = points if affine else curve.normalize(points)
    sc = scalars_std.to(torch.int64)
    seg_key = torch.repeat_interleave(torch.arange(C, device=dev) * K,
                                      torch.tensor(sizes, device=dev))
    ks = torch.arange(C * K, device=dev)
    wc = max(min(W, MAX_DENSE_ENTRIES // max(N, 1)), 1)
    carry = torch.zeros(N, dtype=torch.int64, device=dev)
    parts = []
    for w0 in range(0, W, wc):
        ws = range(w0, min(W, w0 + wc))
        digs, negs, carry = _signed_digit_block(sc, c, ws, carry)
        sorted_k, sorted_i = torch.sort(seg_key[None] + digs, dim=1, stable=True)
        queries = ks.repeat(len(ws), 1)
        starts = torch.searchsorted(sorted_k, queries)
        ends = torch.searchsorted(sorted_k, queries, right=True)
        lens = torch.where(ks % K == 0, 0, ends - starts)  # digit 0 adds nothing
        wl = torch.arange(len(ws), device=dev)
        offs = (wl * N)[:, None]
        parts.append(_dense_bucket_sums(
            curve, aff, sorted_i.reshape(-1), torch.gather(negs, 1, sorted_i).reshape(-1),
            (sorted_k + (wl * C * K)[:, None]).reshape(-1),
            (ends + offs).reshape(-1), (starts + offs).reshape(-1), lens.reshape(-1)))
    acc = map_points(lambda *a: torch.cat(a).reshape(W, C, K, a[0].shape[-1]), *parts)
    return _horner_windows(curve, _weighted_bucket_totals(curve, acc), c)


def _msm_1d_dense(curve: Curve, points: PointJ, scalars_std: torch.Tensor, c: int,
                  affine: bool = False) -> PointJ:
    """One MSM on the dense core at window width ``c``: points [N], scalars
    [N, L] -> PointJ [] (the JAX package's flat entry, which its oracle
    tests call): one segment of ``_msm_ragged_dense``."""
    res = _msm_ragged_dense(curve, points, scalars_std, (scalars_std.shape[0],), c, affine)
    return map_points(lambda a: a[0], res)


def _pick_c(max_size: int) -> int:
    """Window width of the non-dense cores by the largest segment."""
    if max_size >= 8192:
        return 8
    if max_size >= 512:
        return 6
    return 4


def _chunk_plan(sizes, chunk):
    """(chunk sizes, segment of each chunk): segments above ``chunk``
    points split into full chunks and a remainder."""
    chunk_sizes, seg_of_chunk = [], []
    for s_idx, n in enumerate(sizes):
        parts = [n] if chunk is None or n <= chunk else [chunk] * (n // chunk) + (
            [n % chunk] if n % chunk else [])
        chunk_sizes += parts
        seg_of_chunk += [s_idx] * len(parts)
    return tuple(chunk_sizes), tuple(seg_of_chunk)


def _msm_ragged_core(curve: Curve, points: PointJ, scalars_std: torch.Tensor,
                     chunk_sizes: tuple, c: int, affine: bool) -> PointJ:
    """Non-dense segmented bucket MSM: points [N], scalars [N, L] split into
    consecutive chunks of ``chunk_sizes``; returns the chunk partials
    PointJ [len(chunk_sizes)].

    Per window the entries sort by (chunk, unsigned digit); bucket k of
    chunk j in window w is lane (w, j*2^c + k) of a [W, C*2^c] grid, which
    step t of the loop extends by its t-th member (``add_mixed_masked``,
    masked past the bucket's length; digit 0 adds nothing).  The loop runs
    as many steps as the fullest bucket holds, a number read on the host."""
    N = scalars_std.shape[0]
    dev = scalars_std.device
    K = 1 << c
    C = len(chunk_sizes)
    W = -(-scalars_std.shape[-1] * LIMB_BITS // c)
    aff = points if affine else curve.normalize(points)
    sc = scalars_std.to(torch.int64)
    chunk_key = torch.repeat_interleave(torch.arange(C, device=dev) * K,
                                        torch.tensor(chunk_sizes, device=dev))
    digits = torch.stack([_digit(sc, c, w) for w in range(W)])  # [W, N]
    sorted_k, sorted_i = torch.sort(chunk_key[None] + digits, dim=1, stable=True)
    ks = torch.arange(C * K, device=dev)
    queries = ks.repeat(W, 1)
    starts = torch.searchsorted(sorted_k, queries)
    lens = torch.searchsorted(sorted_k, queries, right=True) - starts
    lens = torch.where(ks % K == 0, 0, lens)  # digit-0 buckets stay idle
    acc = curve.infinity((W, C * K))
    for t in range(int(lens.max())):
        pid = torch.gather(sorted_i, 1, (starts + t).clamp(max=N - 1))  # [W, C*K]
        acc = curve.add_mixed_masked(acc, map_points(lambda a: a[pid], aff), lens > t)
    acc = map_points(lambda a: a.reshape(W, C, K, a.shape[-1]), acc)
    return _horner_windows(curve, _weighted_bucket_totals(curve, acc), c)


def _msm_1d_buckets(curve: Curve, points: PointJ, scalars_std: torch.Tensor, batch: int,
                    c: int, affine: bool) -> PointJ:
    """``batch`` independent non-dense MSMs of N points each (points [B*N],
    scalars [B*N, L], instance-major) -> PointJ [B]: each instance is one
    chunk of ``_msm_ragged_core``'s grid.  Its buckets, their members and
    the order they are added in are the JAX package's ``_msm_1d_buckets``
    per instance; the weighted reduce's lane gate sees W*B lanes instead
    of W, which changes the Jacobian representative, not the value."""
    N = scalars_std.shape[0] // batch
    return _msm_ragged_core(curve, points, scalars_std, (N,) * batch, c, affine)


def _segment_sums(curve: Curve, res: PointJ, seg_of_chunk: tuple) -> PointJ:
    """Chunk partials [C] -> segment sums [S], each segment's chunks added
    in order (the JAX package's host loop, msm.py:995-1005); one add per
    chunk rank over the segments that have that many chunks."""
    by_seg: dict = {}
    for ci, sg in enumerate(seg_of_chunk):
        by_seg.setdefault(sg, []).append(ci)
    chunks = [by_seg[s] for s in range(len(by_seg))]
    out = map_points(lambda a: a[[ch[0] for ch in chunks]], res)
    for j in range(1, max(len(ch) for ch in chunks)):
        segs = [s for s, ch in enumerate(chunks) if len(ch) > j]
        summed = curve.add(map_points(lambda a: a[segs], out),
                           map_points(lambda a: a[[chunks[s][j] for s in segs]], res))
        out = map_points(lambda o, v: o.index_copy(0, torch.tensor(segs, device=o.device), v),
                         out, summed)
    return out


def _align(x: torch.Tensor, bshape: tuple) -> torch.Tensor:
    """[b..., N, L] -> [bshape..., N, L], batch dims aligned as prefixes."""
    b = x.shape[:-2]
    return x.reshape(b + (1,) * (len(bshape) - len(b)) + x.shape[-2:]).expand(
        bshape + x.shape[-2:])


def msm(curve: Curve, points: PointJ, scalars_std: torch.Tensor, c: int = 8,
        affine: bool = False) -> PointJ:
    """Batched MSM: points [..., N], scalars [..., N, L] (standard form);
    batch dims align as prefixes (extra scalar batch dims broadcast the
    points).  Returns PointJ [...].  ``c`` is a hint the dense core
    replaces by its cost model, as the JAX package's default does; the
    non-dense core takes it as given.  ``affine``: the points are already
    normalized."""
    N = scalars_std.shape[-2]
    pb, sb = points.x.shape[:-2], scalars_std.shape[:-2]
    batch = sb if len(sb) >= len(pb) else pb
    pts = map_points(lambda a: _align(a, batch), points)
    sc = _align(scalars_std, batch)
    if N <= NAIVE_MAX:
        return msm_naive(curve, pts, sc)
    Bn = math.prod(batch)
    flat = map_points(lambda a: a.reshape(Bn * N, a.shape[-1]), pts)
    sc = sc.reshape(Bn * N, sc.shape[-1])
    if _dense_enabled():
        c = _pick_c_dense(Bn * N, Bn, sc.shape[-1] * LIMB_BITS)
        res = _msm_ragged_dense(curve, flat, sc, (N,) * Bn, c, affine)
    else:
        res = _msm_1d_buckets(curve, flat, sc, Bn, c, affine)
    return map_points(lambda a: a.reshape(batch + a.shape[-1:]), res)


def msm_naive(curve: Curve, points: PointJ, scalars_std: torch.Tensor) -> PointJ:
    """Per-point scalar_mul, then a tree sum over the points axis."""
    return curve.sum(curve.scalar_mul(points, scalars_std), axis=-1)


def msm_ragged(curve: Curve, bases_list, scalars_list, c: int | None = None,
               affine: bool = False, chunk: int | None = RAGGED_CHUNK):
    """MSMs of different sizes in one bucket pass.

    ``bases_list[i]``: PointJ [b..., N_i] whose batch dims align as
    prefixes of the scalars' (as in ``msm``: per-party bases [P, N_i] serve
    scalars [P, B, N_i]; batch-free bases broadcast); ``scalars_list[i]``:
    [B..., N_i, L], all with the same batch shape.  Returns a list of
    PointJ [B...], one per entry.
    The non-dense core splits segments into chunks of at most ``chunk``
    points and adds the chunk partials; the dense core does not chunk."""
    batch = scalars_list[0].shape[:-2]
    Bn = math.prod(batch)
    sizes, pts, scs = [], [], []
    for b, s in zip(bases_list, scalars_list):
        if s.shape[:-2] != batch:
            raise ValueError(f"scalar batch {tuple(s.shape[:-2])} != {tuple(batch)}")
        n_i = s.shape[-2]
        pts.append(map_points(lambda a: _align(a, batch).reshape(Bn * n_i, a.shape[-1]), b))
        scs.append(s.reshape(Bn * n_i, s.shape[-1]))
        sizes += [n_i] * Bn  # batch-major segments per entry
    scal = torch.cat(scs)
    flat = map_points(lambda *a: torch.cat(a), *pts)
    if _dense_enabled():
        if c is None:
            c = _pick_c_dense(sum(sizes), len(sizes), scal.shape[-1] * LIMB_BITS)
        res = _msm_ragged_dense(curve, flat, scal, tuple(sizes), c, affine)
    else:
        if c is None:
            c = _pick_c(max(sizes))
        chunk_sizes, seg_of_chunk = _chunk_plan(sizes, chunk)
        res = _msm_ragged_core(curve, flat, scal, chunk_sizes, c, affine)
        res = _segment_sums(curve, res, seg_of_chunk)
    return [map_points(lambda a, k=k: a[k * Bn:(k + 1) * Bn].reshape(batch + a.shape[-1:]), res)
            for k in range(len(scalars_list))]


# ---------------------------------------------------------------------------
# Distributed MSM on shares (dmsm.rs:9-43)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _dmsm_reduce_vectors(pp: PackedSharingParams):
    """(w [1, n], q [n, 1]) int matrices of the fused leader map:
    leader(x)[j] = pack(replicate_l(sum_l(unpack2(x))))[j] = q[j] (w . x)."""
    p = pp.field.p
    U2, P = pp.unpack2_matrix(), pp.pack_matrix()
    w = np.empty((1, pp.n), dtype=object)
    q = np.empty((pp.n, 1), dtype=object)
    for j in range(pp.n):
        w[0, j] = sum(int(U2[i, j]) for i in range(pp.l)) % p
        q[j, 0] = sum(int(P[j, i]) for i in range(pp.l)) % p
    return w, q


@functools.lru_cache(maxsize=None)
def _dmsm_scale_consts(pp: PackedSharingParams):
    """Host limb constants of the fold: ``qw0`` [L] = q_0 * sum_j w_j
    (leader-mode pre-scale, Montgomery), ``w_mont`` [n, L] (sim-mode
    pre-scale), ``q_std`` [n, L] (sim-mode post scalars, standard form)."""
    F = pp.field
    w, q = _dmsm_reduce_vectors(pp)
    wsum = sum(int(w[0, j]) for j in range(pp.n)) % F.p
    qw0 = F.to_mont_int(int(q[0, 0]) * wsum % F.p)
    w_mont = np.stack([F.to_mont_int(int(w[0, j])) for j in range(pp.n)])
    q_std = np.stack([int_to_limbs(int(q[j, 0]), F.L) for j in range(pp.n)])
    return qw0, w_mont, q_std


def _dmsm_prescale(pp: PackedSharingParams, net: PartyNet,
                   scalars_std: torch.Tensor) -> torch.Tensor:
    """Fold the leader map's scalar factors into standard-form scalars:
    F.mul(s, to_mont(k)) = s*k mod r, still standard form.  Leader mode
    folds q_0 * sum(w); sim mode folds the per-party w_j."""
    F = pp.field
    qw0, w_mont, _ = _dmsm_scale_consts(pp)
    if net.mode == "leader":
        return F.mul(scalars_std, F._tensor(qw0))
    w = net.party_rows(F._tensor(w_mont))  # party p's w_p
    return F.mul(scalars_std, w.reshape(w.shape[:1] + (1,) * (scalars_std.ndim - 2) + (F.L,)))


def d_msm(curve: Curve, pp: PackedSharingParams, net: PartyNet, bases: PointJ,
          scalars_std: torch.Tensor, c: int = 8) -> PointJ:
    """Batched distributed MSM on PSS shares.

    ``bases``: PointJ [P, B, M] (or broadcastable); ``scalars_std``: [P, B,
    M, L] standard-form share scalars.  Returns PointJ [P, B]: fresh shares
    whose every secret slot is the MSM (dmsm.rs:35), value-identical to
    the reference's leader map."""
    local = msm(curve, bases, _dmsm_prescale(pp, net, scalars_std), c=c)  # [P, B]
    B = local.x.shape[-2]
    size = net.payload_bytes("g1", B, vec=True)
    net._count_gather(size)
    if net.mode == "leader":  # counting only: one gather + one scatter round
        net._count_scatter(size)
        return local
    t = curve.sum(net.gather_data_only(local), axis=0)  # [B] = w . x
    # the root scatters q_j (w . x) to party j: each process scales its rows
    q = net.party_rows(curve.fr._tensor(_dmsm_scale_consts(pp)[2]))
    tb = map_points(lambda a: a[None].expand(q.shape[:1] + a.shape), t)
    out = curve.scalar_mul(tb, q[:, None, :])  # [P, B]
    net._count_scatter(size)
    return out
