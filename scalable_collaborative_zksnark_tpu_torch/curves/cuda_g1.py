"""G1 point kernels: CUDA wrappers and their plain PyTorch versions.

Replaces ``curves/pallas_g1.py``: ``_add_kernel`` (``add``, ``add_mixed``)
and ``_double_kernel`` behind ``point_op``; ``_add_masked_kernel``
(``add_masked``) and ``_add_reset_kernel`` (``add_reset``);
``_add_reset_lazy_kernel``
with the scan and repair around it in ``primitives/msm.py`` and the joins
of its lanes (``accumulate``: the bucket sums); ``_scalar_mul_kernel``
(``scalar_mul``); ``_horner_kernel`` (``horner``); ``_bucket_serial_kernel``
(``bucket_serial``).  The kernels are ``csrc/g1.cu`` on the group law of
``csrc/g1.cuh``, and ``csrc/g1_chain.cu`` (Horner, bucket-serial); every
kernel but bucket-serial runs the formulas by dependency levels on a team
of lanes (``csrc/g1_team.cuh``), all of them on the low-latency product
of ``csrc/fq_chain.cuh``; see those files for the design and what bounds
it.  Bucket-serial runs a segmented schedule (``bucket_segments``), which
its plain version follows step for step.

A point is a tuple ``(x, y, z)`` of ``int32 [..., 24]`` Fq Montgomery
limbs (Jacobian; z = 0 is infinity, written (0, 1, 0)).  A CPU tensor
goes through the plain version (``*_plain``), a CUDA tensor through the
kernel; a failed build or launch raises.  Each wrapper counts its kernel
launches in ``.launches``.

The plain versions run the formulas of the JAX package's ``Curve.add``,
``add_mixed`` and ``double`` on the plain ``int64`` field ops of
``fields/cuda_fr.py``.  Products that do not depend on each other go
through one call (``_mul``), and the doubling of a complete add is
computed only when a lane needs it; neither changes a value.  They are
the reference the tests and ``chip_smoke.py`` hold the kernels to, and
nothing on the card's path calls them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build
from ..fields import cuda_fr
from ..fields.config import FieldSpec
from ..utils import timer

SENTINEL = 0xFFFFFFFF  # key of the accumulate's padding entries (msm.py)
_OPS = {"add": 0, "add_mixed": 1, "double": 2}
_MASKED_OPS = {"add_masked": 0, "add_reset": 1}

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sczk_g1_point_op": [_I] + [_VP] * 9 + [_I, _VP, _VP],
    "sczk_g1_masked_op": [_I] + [_VP] * 10 + [_I, _VP, _VP],
    "sczk_g1_accumulate": [_VP, _VP, _VP, _LL] + [_VP] * 3 + [_I] * 3 + [_VP] * 10,
    "sczk_g1_accumulate_lanes": [_VP],
    "sczk_g1_scalar_mul": [_VP, _VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP],
    "sczk_g1_attrs": [_I, _VP],
    "sczk_fq_mul_chain": [_VP, _I, _VP, _VP, _VP],
    "sczk_imad_chain": [_VP, _I, _VP, _VP],
}
_CHAIN_SIGNATURES = {
    "sczk_g1_horner": [_VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP],
    "sczk_g1_bucket_serial": [_VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP],
    "sczk_fq_mul_cc": [_VP, _VP, _VP, _I, _VP, _VP],
    "sczk_fq_mul_cc_chain": [_VP, _I, _VP, _VP, _VP],
    "sczk_g1_chain_attrs": [_I, _VP],
}
# kernels of csrc/g1.cu and of csrc/g1_chain.cu, in their attrs entries' order
ATTR_KERNELS = ("add", "add_mixed", "double", "accumulate", "scalar_mul", "add_masked",
                "add_reset", "accumulate_join")
CHAIN_ATTR_KERNELS = ("horner", "bucket_serial")

MAX_ACCUMULATE_BASES = 1 << 29  # the accumulate stages a base index in 29 bits
SCAN_LANES = 64  # scan lanes a block of the accumulate's walk (csrc/g1.cu kScanLanes)
JOIN_TEAMS = 128  # teams of the accumulate's join over blocks (csrc/g1.cu kJoinTeams)
MIN_STEPS = 32
"""Entries a lane of the accumulate walks at least, while that leaves it
``MIN_LANES`` lanes: a lane's share of the joins across lanes is up to
seven general adds, which this keeps under a third of its walk."""
MIN_LANES = 512  # lanes a short accumulate still spreads over
LADDER_WINDOW = 4  # bits a window of the ladder (csrc/g1.cu kWindowBits)

SEGMENT_FILL_THREADS = 132 * 4 * 32
"""Threads that put four warps on each of the H100's 132 SMs: bucket-serial
cuts a lane's buckets into segments only while M * S stays within it."""
MAX_SEGMENTS = 64  # a lane's segments share one block of csrc/g1_chain.cu


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def infinity(spec: FieldSpec, shape, device) -> tuple:
    """(0, 1, 0) in Montgomery form, ``shape`` points (contiguous)."""
    timer.count("sync.upload.g1_one")
    one = torch.from_numpy(spec.r_limbs.astype(np.int32)).to(device)
    zero = torch.zeros(tuple(shape) + (spec.num_limbs,), dtype=torch.int32, device=device)
    return zero, one.expand_as(zero).contiguous(), zero.clone()


def select(cond: torch.Tensor, a: tuple, b: tuple) -> tuple:
    """cond ? a : b per point (cond shaped like the batch)."""
    c = cond[..., None]
    return tuple(torch.where(c, u, v) for u, v in zip(a, b))


def _mul(spec: FieldSpec, *pairs):
    """Products of independent same-shape pairs in one plain call."""
    a = torch.stack([x for x, _ in pairs])
    b = torch.stack([y for _, y in pairs])
    return cuda_fr.mul_plain(spec, a, b).unbind(0)


def double_plain(spec: FieldSpec, pt: tuple) -> tuple:
    """dbl-2009-l (``Curve.double``); doubling infinity keeps z = 0."""
    add = functools.partial(cuda_fr.add_plain, spec)
    sub = functools.partial(cuda_fr.sub_plain, spec)
    X, Y, Z = pt
    A, B, YZ = _mul(spec, (X, X), (Y, Y), (Y, Z))
    t = add(X, B)
    C, t = _mul(spec, (B, B), (t, t))
    D = sub(sub(t, A), C)
    D = add(D, D)
    E = add(add(A, A), A)
    (G,) = _mul(spec, (E, E))
    X3 = sub(G, add(D, D))
    C8 = add(C, C)
    C8 = add(C8, C8)
    C8 = add(C8, C8)
    (Y3,) = _mul(spec, (E, sub(D, X3)))
    Y3 = sub(Y3, C8)
    Z3 = add(YZ, YZ)
    Z3 = torch.where(_is_zero(Z)[..., None], torch.zeros_like(Z3), Z3)
    return X3, Y3, Z3


def add_plain(spec: FieldSpec, p1: tuple, p2: tuple, mixed: bool = False):
    """Complete add-2007-bl (madd-2007-bl with ``mixed``: z2 in {0, 1}),
    the selects of ``Curve.add``.  Returns (sum, lanes that doubled)."""
    add = functools.partial(cuda_fr.add_plain, spec)
    sub = functools.partial(cuda_fr.sub_plain, spec)
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if mixed:
        Z1Z1, Y2Z1 = _mul(spec, (Z1, Z1), (Y2, Z1))
        U1, S1 = X1, Y1
        U2, S2 = _mul(spec, (X2, Z1Z1), (Y2Z1, Z1Z1))
    else:
        ZS = add(Z1, Z2)
        Z1Z1, Z2Z2, Y1Z2, Y2Z1, ZS2 = _mul(spec, (Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (ZS, ZS))
        U1, S1, U2, S2 = _mul(spec, (X1, Z2Z2), (Y1Z2, Z2Z2), (X2, Z1Z1), (Y2Z1, Z1Z1))
    H = sub(U2, U1)
    r = sub(S2, S1)
    if mixed:
        HH, Z3 = _mul(spec, (H, H), (add(Z1, Z1), H))
    else:
        HH, Z3 = _mul(spec, (H, H), (sub(sub(ZS2, Z1Z1), Z2Z2), H))
    I = add(HH, HH)
    I = add(I, I)
    r2 = add(r, r)
    J, V, R2 = _mul(spec, (H, I), (U1, I), (r2, r2))
    X3 = sub(sub(R2, J), add(V, V))
    T, SJ = _mul(spec, (r2, sub(V, X3)), (S1, J))
    Y3 = sub(T, add(SJ, SJ))
    inf1, inf2 = _is_zero(Z1), _is_zero(Z2)
    same_x = _is_zero(H) & ~(inf1 | inf2)
    is_dbl = same_x & _is_zero(r)
    out = (X3, Y3, Z3)
    if bool(is_dbl.any()):
        out = select(is_dbl, double_plain(spec, p1), out)
    out = select(same_x & ~is_dbl, infinity(spec, X3.shape[:-1], X3.device), out)
    out = select(inf2, p1, out)
    return select(inf1, p2, out), is_dbl


def masked_plain(spec: FieldSpec, p1: tuple, p2: tuple, mask: torch.Tensor,
                 keep_first: bool) -> tuple:
    """mask ? p1 + p2 (mixed) : (p1 if ``keep_first`` else p2), the add
    computed on the masked lanes only (``Curve.add_mixed_masked`` /
    ``add_mixed_reset``)."""
    p1, p2, mask = _broadcast_masked(p1, p2, mask)
    out = tuple(a.clone(memory_format=torch.contiguous_format)
                for a in (p1 if keep_first else p2))
    idx = mask.nonzero(as_tuple=True)
    if idx[0].numel():
        summed = add_plain(spec, tuple(a[idx] for a in p1), tuple(a[idx] for a in p2),
                           mixed=True)[0]
        for o, s in zip(out, summed):
            o[idx] = s
    return out


def neg_y_plain(spec: FieldSpec, y: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """y -> p - y where ``neg`` (``Field.neg``: 0 - y)."""
    return torch.where(neg[..., None], cuda_fr.sub_plain(spec, torch.zeros_like(y), y), y)


def _take(pt: tuple, idx: torch.Tensor) -> tuple:
    return tuple(a[idx] for a in pt)


def _put(pt: tuple, idx: torch.Tensor, vals: tuple) -> tuple:
    return tuple(a.index_copy(0, idx, v) for a, v in zip(pt, vals))


def _add_counted(spec: FieldSpec, p1: tuple, p2: tuple, mixed: bool = False):
    """``add_plain``'s sum and the number of lanes that doubled."""
    out, dbl = add_plain(spec, p1, p2, mixed)
    return out, int(dbl.sum())


def accumulate_plain(spec: FieldSpec, keys: torch.Tensor, pid: torch.Tensor, neg: torch.Tensor,
                     bases: tuple, T: int, NB: int, K: int):
    """The dense MSM's bucket sums (``msm.py`` ``_dense_bucket_sums``) on
    the kernels' schedule, add for add.

    Entry e of the key-sorted list (``keys`` ascending, below NB) is the
    point ``bases[pid[e]]``, negated where ``neg[e]``.  Bucket k is the
    sum of the entries of key k; infinity where none has key k or k % K
    == 0 (digit 0).  The list is padded to T*steps entries (steps =
    ceil(E / T)) with key ``SENTINEL`` and infinity; lane t walks entries
    [t*steps, (t+1)*steps), ``(key == previous key) ? acc + P : P``.  A
    run that ends inside a lane and did not begin at its first step is a
    whole bucket.  Each lane's last run (its trail) joins a segmented
    Hillis-Steele scan over the lanes of its block of ``SCAN_LANES``
    (v[t] = v[t - d] + v[t] where lanes t - d + 1 .. t all hold one key
    and continue the lane before); a lane's first run (its lead) follows
    the chain ending at the lane before (v[t - 1] + lead).  A lead whose
    chain reaches back into the block before goes, with each block's
    trailing chain, to the join over blocks: ``JOIN_TEAMS`` teams of g =
    ceil(G / JOIN_TEAMS) blocks, each scanning its blocks in order, a
    segmented Hillis-Steele scan over the teams, then per head (P[q-1] +
    A[j-1]) + head.  Returns (buckets [NB], adds that doubled)."""
    E = keys.shape[0]
    steps = -(-E // T)
    dev = keys.device
    pad = T * steps - E
    pts = tuple(b[pid] for b in bases)
    pts = (pts[0], neg_y_plain(spec, pts[1], neg), pts[2])
    kl = torch.cat([keys, torch.full((pad,), SENTINEL, dtype=keys.dtype, device=dev)])
    pts = tuple(torch.cat([a, f]) for a, f in zip(pts, infinity(spec, (pad,), dev)))
    kl = kl.reshape(T, steps)
    pts = tuple(a.reshape(T, steps, -1) for a in pts)
    acc = infinity(spec, (T,), dev)
    prev = torch.full((T,), SENTINEL, dtype=keys.dtype, device=dev)
    walk, doubled = [], 0
    for s in range(steps):
        p = tuple(a[:, s] for a in pts)
        same = kl[:, s] == prev
        summed, dbl = add_plain(spec, acc, p, mixed=True)
        acc = select(same, summed, p)
        doubled += int((same & dbl).sum())
        prev = kl[:, s]
        walk.append(acc)
    walk = tuple(torch.stack([w[j] for w in walk], dim=1) for j in range(3))  # [T, steps]

    out = infinity(spec, (NB,), dev)

    def write(key, val):  # put_bucket: digit 0 stays infinity, padding writes nothing
        ok = (key < NB) & (key % K != 0)
        return _put(out, key[ok], _take(val, ok))

    # runs: the lead ends at its lane's first run end; others inside are whole
    ends = torch.ones((T, steps), dtype=torch.bool, device=dev)
    ends[:, :-1] = kl[:, 1:] != kl[:, :-1]
    lead_at = ends.to(torch.int8).argmax(dim=1)
    lanes = torch.arange(T, device=dev)
    steps_at = torch.arange(steps, device=dev)
    inner = ends & (steps_at[None] != lead_at[:, None]) & (steps_at[None] != steps - 1)
    t_in, s_in = inner.nonzero(as_tuple=True)
    out = write(kl[t_in, s_in], tuple(a[t_in, s_in] for a in walk))
    lead = tuple(a[lanes, lead_at] for a in walk)
    trail = tuple(a[:, -1] for a in walk)
    first, last = kl[:, 0], kl[:, -1]
    uni = lead_at == steps - 1
    cl = torch.zeros(T, dtype=torch.bool, device=dev)
    cl[1:] = first[1:] == last[:-1]
    cr = torch.zeros(T, dtype=torch.bool, device=dev)
    cr[:-1] = last[:-1] == first[1:]

    # the blocks' Hillis-Steele scan over the trails
    i = lanes % SCAN_LANES
    v, wh = trail, uni & cl
    d = 1
    while d < SCAN_LANES:
        at = ((i >= d) & wh).nonzero(as_tuple=True)[0]
        if at.numel():
            summed, n = _add_counted(spec, _take(v, at - d), _take(v, at))
            doubled += n
            wh = wh.index_copy(0, at, wh[at - d])
            v = _put(v, at, summed)
        d *= 2
    G = -(-T // SCAN_LANES)
    block_last = torch.clamp(torch.arange(1, G + 1, device=dev) * SCAN_LANES, max=T) - 1
    tails, link = _take(v, block_last), wh[block_last]
    out = write(last[~uni & ~cr], _take(trail, ~uni & ~cr))

    # each lane's lead bucket
    wh_before = torch.ones(T, dtype=torch.bool, device=dev)
    wh_before[1:] = wh[:-1]
    head = cl & ((i == 0) | wh_before)
    lt = select(uni, v, lead)
    at = (~uni & cl & (i > 0)).nonzero(as_tuple=True)[0]
    if at.numel():
        summed, n = _add_counted(spec, _take(v, at - 1), _take(lead, at))
        doubled += n
        lt = _put(lt, at, summed)
    done = ~(uni & cr)
    is_head = done & head & (first < NB) & (first % K != 0)
    out = write(first[done & ~is_head], _take(lt, done & ~is_head))
    if G == 1:
        return out, doubled
    hb = lanes[is_head] // SCAN_LANES  # the head's block
    heads = _put(infinity(spec, (G,), dev), hb, _take(lt, is_head))
    has_head = torch.zeros(G, dtype=torch.bool, device=dev).index_fill(0, hb, True)
    head_key = first[torch.arange(G, device=dev) * SCAN_LANES]

    # the join over blocks
    g = -(-G // JOIN_TEAMS)
    teams = -(-G // g)
    q = torch.arange(teams, device=dev)
    A = tails
    for o in range(1, g):
        j = q * g + o
        at = j[(j < G) & link[j.clamp(max=G - 1)]]
        if at.numel():
            summed, n = _add_counted(spec, _take(A, at - 1), _take(A, at))
            doubled += n
            A = _put(A, at, summed)
    team_last = torch.clamp(q * g + g, max=G) - 1
    full = torch.ones(teams * g, dtype=torch.bool, device=dev)
    wq = full.index_copy(0, torch.arange(G, device=dev), link).reshape(teams, g).all(dim=1)
    P = _take(A, team_last)
    d = 1
    while d < teams:
        at = ((q >= d) & wq).nonzero(as_tuple=True)[0]
        if at.numel():
            summed, n = _add_counted(spec, _take(P, at - d), _take(P, at))
            doubled += n
            wq = wq.index_copy(0, at, wq[at - d])
            P = _put(P, at, summed)
        d *= 2
    reach = torch.ones(teams, dtype=torch.bool, device=dev)
    for o in range(g):
        j = q * g + o
        real = j < G
        jc = j.clamp(max=G - 1)
        at = (real & has_head[jc]).nonzero(as_tuple=True)[0]  # teams with a head at offset o
        if at.numel():
            jj = j[at]
            if o == 0:
                gm = _take(P, at - 1)
            else:
                gm = _take(A, jj - 1)
                r = at[reach[at]]
                if r.numel():
                    summed, n = _add_counted(spec, _take(P, r - 1), _take(A, j[r] - 1))
                    doubled += n
                    pos = torch.searchsorted(at, r)
                    gm = _put(gm, pos, summed)
            summed, n = _add_counted(spec, gm, _take(heads, jj))
            doubled += n
            out = _put(out, head_key[jj], summed)
        reach = reach & (~real | link[jc])
    return out, doubled


def scalar_mul_plain(spec: FieldSpec, pt: tuple, scalars: torch.Tensor) -> tuple:
    """pt * scalar over standard-form 16-bit scalar limbs (``Curve.scalar_mul``'s
    value) by fixed windows of ``LADDER_WINDOW`` bits, MSB first, on the
    kernel's schedule step for step: the table T_1 = P, T_2 = 2P, T_k =
    T_{k-1} + P up to k = 15, then for each window four doublings of acc
    (from infinity) and acc + T_digit where the digit is not 0; ``pt`` and
    ``scalars`` share their batch shape."""
    shape = pt[0].shape[:-1]
    pt = tuple(a.reshape(-1, a.shape[-1]) for a in pt)
    w_all = scalars.reshape(-1, scalars.shape[-1])
    table = [pt, double_plain(spec, pt)]
    for _ in range(3, 1 << LADDER_WINDOW):
        table.append(add_plain(spec, table[-1], pt)[0])
    table = tuple(torch.stack(t) for t in zip(*table))  # [15, m, 24]: T_1 .. T_15
    acc = infinity(spec, (pt[0].shape[0],), pt[0].device)
    for limb in range(scalars.shape[-1] - 1, -1, -1):
        w = w_all[:, limb]
        for b in range(16 - LADDER_WINDOW, -1, -LADDER_WINDOW):
            for _ in range(LADDER_WINDOW):
                acc = double_plain(spec, acc)
            digit = (w >> b) & ((1 << LADDER_WINDOW) - 1)
            idx = (digit > 0).nonzero(as_tuple=True)[0]  # lanes that add, as the kernel
            if idx.numel():
                entry = tuple(a[digit[idx].long() - 1, idx] for a in table)
                summed = add_plain(spec, tuple(a[idx] for a in acc), entry)[0]
                for a, s in zip(acc, summed):
                    a[idx] = s
    return tuple(a.reshape(shape + a.shape[-1:]) for a in acc)


def horner_plain(spec: FieldSpec, totals: tuple, c: int) -> tuple:
    """sum_w 2^(c*w) T_w over totals [W, C] (window 0 least significant),
    MSB window first: c doublings, then one general add."""
    acc = infinity(spec, totals[0].shape[1:-1], totals[0].device)
    for w in range(totals[0].shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = double_plain(spec, acc)
        acc = add_plain(spec, acc, tuple(a[w] for a in totals))[0]
    return acc


def bucket_segments(K: int, M: int) -> int:
    """Segments S per lane of bucket-serial over buckets [K, M]: the power
    of two that makes one lane's chain of point ops shortest (its segment's
    running suffix, 2 (L - 1) adds for L = ceil((K - 1) / S), then the
    combine: S - 1 adds of the V_s, 2 (S - 2) of the suffix over the R_s,
    the double-and-add by L and one add), as long as M * S threads fit
    ``SEGMENT_FILL_THREADS``; 1 (the plain running suffix) when no S > 1
    shortens it.  The kernel and ``bucket_serial_plain`` both read it."""
    def chain(S):
        L = -(-(K - 1) // S)
        if S == 1:
            return 2 * (L - 1)
        return 2 * (L - 1) + (S - 1) + 2 * (S - 2) + L.bit_length() + bin(L).count("1") - 1

    best, S = 1, 2
    while S <= min((K - 1) // 2, MAX_SEGMENTS) and M * S <= SEGMENT_FILL_THREADS:
        if chain(S) < chain(best):
            best = S
        S *= 2
    return best


def _segments(K: int, M: int, segments: int | None) -> int:
    """``segments``, or ``bucket_segments(K, M)`` when it is None; 1 to
    ``MAX_SEGMENTS``."""
    S = bucket_segments(K, M) if segments is None else segments
    if not 1 <= S <= MAX_SEGMENTS:
        raise ValueError(f"{S} segments per lane; bucket-serial takes 1 to {MAX_SEGMENTS}")
    return S


def bucket_serial_plain(spec: FieldSpec, buckets: tuple, segments: int | None = None) -> tuple:
    """sum_{k>=1} k*B_k over buckets [K, M] (k ascending) on the kernel's
    segmented schedule, step for step: S = ``segments`` (default
    ``bucket_segments(K, M)``) segments of L = ceil((K - 1) / S) buckets;
    segment s runs the running suffix over k = min((s+1)L, K-1) .. sL+1
    from acc = total = infinity (acc += B_k, total += acc), giving R_s and
    V_s = sum (k - sL) B_k; then sum_s V_s in order, the running suffix
    over R_{S-1} .. R_1 (sum_s s R_s), its multiple by L (MSB-first
    double-and-add) and one last add.  With S = 1 that is the running
    suffix alone."""
    K, M = buckets[0].shape[:2]
    S = _segments(K, M, segments)
    L = -(-(K - 1) // S)
    dev = buckets[0].device
    # buckets 1 .. K-1, padded above with infinity to S*L; the padding
    # comes first in the descending walk, where acc and total are still
    # infinity, and adding infinity to infinity leaves them as they were
    body = tuple(a[1:] for a in buckets)
    if S * L > K - 1:
        body = tuple(torch.cat([a, f])
                     for a, f in zip(body, infinity(spec, (S * L - (K - 1), M), dev)))
    seg = tuple(a.reshape(S, L, M, a.shape[-1]) for a in body)
    acc = total = infinity(spec, (S, M), dev)
    for step in range(L - 1, -1, -1):
        acc = add_plain(spec, acc, tuple(a[:, step] for a in seg))[0]
        total = add_plain(spec, total, acc)[0]
    R = [tuple(a[s] for a in acc) for s in range(S)]
    V = [tuple(a[s] for a in total) for s in range(S)]
    out = V[0]
    if S == 1:
        return out
    for s in range(1, S):
        out = add_plain(spec, out, V[s])[0]
    suffix = weighted = R[S - 1]
    for s in range(S - 2, 0, -1):
        suffix = add_plain(spec, suffix, R[s])[0]
        weighted = add_plain(spec, weighted, suffix)[0]
    scaled = weighted
    for bit in bin(L)[3:]:
        scaled = double_plain(spec, scaled)
        if bit == "1":
            scaled = add_plain(spec, scaled, weighted)[0]
    return add_plain(spec, out, scaled)[0]


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def g1_consts(spec: FieldSpec) -> np.ndarray:
    """Host array the kernels take: modulus words, n0, Montgomery 1 words."""
    words = lambda v: [(v >> (32 * k)) & 0xFFFFFFFF for k in range(spec.num_words)]  # noqa: E731
    return np.array(words(spec.modulus) + [spec.n0inv32] + words(spec.r), dtype=np.uint32)


def _check(spec: FieldSpec, *xs: torch.Tensor):
    if spec.num_words != 12:
        raise ValueError(f"the G1 kernels take 381-bit base fields, got {spec.name}")
    for x in xs:
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise TypeError(f"kernel operands must be CUDA int32 tensors, got {x.device} {x.dtype}")


def _operand(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` broadcast to ``shape``, contiguous and 16-byte aligned."""
    x = x.expand(shape).contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _ptrs(pt: tuple):
    return [a.data_ptr() for a in pt]


def _empty(spec: FieldSpec, shape, device) -> tuple:
    return tuple(torch.empty(tuple(shape) + (spec.num_limbs,), dtype=torch.int32, device=device)
                 for _ in range(3))


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _lib():
    return cuda_build.library("g1", _SIGNATURES)


def _chain_lib():
    return cuda_build.library("g1_chain", _CHAIN_SIGNATURES)


def _launch_point_op(wrapper, spec: FieldSpec, p1: tuple, p2: tuple) -> tuple:
    coords = list(p1) + list(p2 or ())
    _check(spec, *coords)
    shape = torch.broadcast_shapes(*(a.shape for a in coords))
    if shape[-1] != spec.num_limbs:
        raise ValueError(f"limb axis {shape[-1]} != {spec.num_limbs}")
    m = shape.numel() // shape[-1]
    out = _empty(spec, shape[:-1], coords[0].device)
    if m == 0:
        return out
    a = [_operand(x, shape) for x in p1]
    b = [_operand(x, shape) for x in p2] if p2 is not None else a
    err = _lib().sczk_g1_point_op(_OPS[wrapper.__name__], *_ptrs(a), *_ptrs(b), *_ptrs(out), m,
                                  g1_consts(spec).ctypes.data, _stream(a[0]))
    wrapper.launches += 1
    cuda_build.check(err, f"g1 {wrapper.__name__}")
    return out


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _broadcast(*pts: tuple) -> list:
    """Points broadcast to one batch shape (materialised, for the plain ops)."""
    shape = torch.broadcast_shapes(*(a.shape for pt in pts for a in pt))
    return [tuple(a.expand(shape) for a in pt) for pt in pts]


def _broadcast_masked(p1: tuple, p2: tuple, mask: torch.Tensor):
    """Two point operands and a per-point mask broadcast to one batch shape."""
    shape = torch.broadcast_shapes(*(a.shape for a in p1 + p2), mask.shape + p1[0].shape[-1:])
    return (tuple(a.expand(shape) for a in p1), tuple(a.expand(shape) for a in p2),
            mask.expand(shape[:-1]))


def _masked_op(wrapper, spec: FieldSpec, p1: tuple, p2: tuple, mask: torch.Tensor) -> tuple:
    if _on_cpu(*p1, *p2, mask):
        return wrapper.plain(spec, p1, p2, mask)
    _check(spec, *p1, *p2)
    if mask.dtype != torch.bool or mask.device != p1[0].device:
        raise TypeError(f"the mask must be a bool tensor on {p1[0].device}, got "
                        f"{mask.device} {mask.dtype}")
    p1, p2, mask = _broadcast_masked(p1, p2, mask)
    shape = p1[0].shape
    if shape[-1] != spec.num_limbs:
        raise ValueError(f"limb axis {shape[-1]} != {spec.num_limbs}")
    m = shape.numel() // shape[-1]
    out = _empty(spec, shape[:-1], mask.device)
    if m == 0:
        return out
    a = [_operand(x, shape) for x in p1]
    b = [_operand(x, shape) for x in p2]
    mk = mask.contiguous()
    err = _lib().sczk_g1_masked_op(_MASKED_OPS[wrapper.__name__], *_ptrs(a), *_ptrs(b),
                                   mk.data_ptr(), *_ptrs(out), m, g1_consts(spec).ctypes.data,
                                   _stream(mk))
    wrapper.launches += 1
    cuda_build.check(err, f"g1 {wrapper.__name__}")
    return out


def add_masked(spec: FieldSpec, p1: tuple, p2: tuple, valid: torch.Tensor) -> tuple:
    """valid ? p1 + p2 : p1 per point, p2 affine or infinity (the non-dense
    MSM's bucket step): on CUDA one launch, a team of 2 lanes a point
    running the mixed add where ``valid`` is set and copying p1 where it
    is not; plain on the CPU."""
    return _masked_op(add_masked, spec, p1, p2, valid)


def add_reset(spec: FieldSpec, p1: tuple, p2: tuple, same: torch.Tensor) -> tuple:
    """same ? p1 + p2 : p2 per point, p2 affine or infinity: on CUDA the
    kernel of ``add_masked`` copying p2 where ``same`` is not set; plain
    on the CPU."""
    return _masked_op(add_reset, spec, p1, p2, same)


def add(spec: FieldSpec, p1: tuple, p2: tuple) -> tuple:
    """Complete general add p1 + p2 (operands broadcast): kernel on CUDA,
    plain on the CPU."""
    if _on_cpu(*p1, *p2):
        return add.plain(spec, p1, p2)
    return _launch_point_op(add, spec, p1, p2)


def add_mixed(spec: FieldSpec, p1: tuple, p2: tuple) -> tuple:
    """Complete mixed add, p2 with z in {0, 1}: on CUDA one launch, a team
    of 2 lanes a point; plain on the CPU."""
    if _on_cpu(*p1, *p2):
        return add_mixed.plain(spec, p1, p2)
    return _launch_point_op(add_mixed, spec, p1, p2)


def double(spec: FieldSpec, pt: tuple) -> tuple:
    """2 * pt: on CUDA one launch, a team of 2 lanes a point; plain on the CPU."""
    if _on_cpu(*pt):
        return double_plain(spec, pt)
    return _launch_point_op(double, spec, pt, None)


class DoubledSteps:
    """The accumulate's adds that doubled, over calls: the plain version's
    count on the host and one int32 counter on each card, which the
    kernels add to where they run, so a pass waits for nothing.
    ``int()`` reads (and waits for) the cards' counters; only tests ask."""

    def __init__(self):
        self.host = 0
        self.cards: dict = {}

    def counter(self, device: torch.device) -> torch.Tensor:
        if device not in self.cards:
            self.cards[device] = torch.zeros(1, dtype=torch.int32, device=device)
        return self.cards[device]

    def __int__(self) -> int:
        return self.host + sum(int(c.item()) for c in self.cards.values())


@functools.lru_cache(maxsize=None)
def resident_lanes(index: int) -> int:
    """Scan lanes of the accumulate's walk resident on every SM of card
    ``index`` at once: blocks an SM at the kernel's occupancy (the CUDA
    runtime's count from its registers and shared memory) times the SMs
    times ``SCAN_LANES``."""
    out = np.zeros(3, dtype=np.int32)
    with torch.cuda.device(index):
        cuda_build.check(_lib().sczk_g1_accumulate_lanes(out.ctypes.data), "accumulate occupancy")
    return int(out[0])


def accumulate_lanes(E: int, device) -> int:
    """Lanes T of an accumulate over E entries on ``device``: on a card the
    lanes it holds at once (``resident_lanes``), fewer where a lane would
    walk under ``MIN_STEPS`` entries (but no fewer than ``MIN_LANES``);
    never more than E.  The plain version takes any T."""
    device = torch.device(device)
    T = max(MIN_LANES, E // MIN_STEPS)
    if device.type == "cuda":
        T = min(T, resident_lanes(device.index if device.index is not None
                                  else torch.cuda.current_device()))
    return max(1, min(T, E))


def accumulate(spec: FieldSpec, keys: torch.Tensor, pid: torch.Tensor, neg: torch.Tensor,
               bases: tuple, T: int, NB: int, K: int) -> tuple:
    """The dense MSM's bucket sums [NB] over T lanes (see
    ``accumulate_plain``): on CUDA the walk and, where it has more than one
    block, the join (two launches); the plain version on the CPU.
    ``accumulate.repaired`` counts the adds that doubled."""
    if _on_cpu(keys, *bases):
        out, doubled = accumulate_plain(spec, keys, pid, neg, bases, T, NB, K)
        accumulate.repaired.host += doubled
        return out
    return _launch_accumulate(spec, keys, pid, neg, bases, T, NB, K)


def _launch_accumulate(spec, keys, pid, neg, bases, T, NB, K):
    _check(spec, *bases)
    E = keys.shape[0]
    if keys.dtype != torch.int64 or pid.dtype != torch.int64 or neg.dtype != torch.bool:
        raise TypeError("keys and pid must be int64, neg bool")
    if pid.shape != (E,) or neg.shape != (E,) or E < 1 or T < 1:
        raise ValueError(f"{E} entries, {tuple(pid.shape)} pid, {tuple(neg.shape)} neg, {T} lanes")
    if not 1 <= NB < SENTINEL or K < 1:
        raise ValueError(f"{NB} buckets, digit-0 period {K}")
    for x in (keys, pid, neg):
        if x.device != bases[0].device:
            raise TypeError(f"operands on {x.device} and {bases[0].device}")
    n = bases[0].shape[0]
    if n >= MAX_ACCUMULATE_BASES:
        raise ValueError(f"{n} bases; the accumulate takes fewer than {MAX_ACCUMULATE_BASES}")
    base = [_operand(a, (n, spec.num_limbs)) for a in bases]
    keys, pid, neg = keys.contiguous(), pid.contiguous(), neg.contiguous()
    G = -(-T // SCAN_LANES)
    out = _empty(spec, (NB,), keys.device)
    scratch = _empty(spec, (2 * G,), keys.device)
    meta = torch.empty(3 * G, dtype=torch.int32, device=keys.device)
    err = _lib().sczk_g1_accumulate(keys.data_ptr(), pid.data_ptr(), neg.data_ptr(), E,
                                    *_ptrs(base), T, NB, K, *_ptrs(out), *_ptrs(scratch),
                                    meta.data_ptr(),
                                    accumulate.repaired.counter(keys.device).data_ptr(),
                                    g1_consts(spec).ctypes.data, _stream(keys))
    accumulate.launches += 1 + (G > 1)
    cuda_build.check(err, "g1 accumulate")
    return out


def scalar_mul(spec: FieldSpec, pt: tuple, scalars: torch.Tensor) -> tuple:
    """pt * scalar per lane (standard-form 16-bit limbs [..., n]; batch
    shapes broadcast): on CUDA one launch, a team of 4 lanes a lane
    walking the plain version's 4-bit windows over a 15-point table,
    bit-equal to it; plain on the CPU."""
    pt, scalars = _broadcast_scalars(pt, scalars)
    if _on_cpu(*pt, scalars):
        return scalar_mul_plain(spec, pt, scalars)
    shape = scalars.shape[:-1]
    _check(spec, *pt, scalars)
    m = shape.numel()
    out = _empty(spec, shape, scalars.device)
    if m == 0:
        return out
    n_limbs = scalars.shape[-1]
    P = [_operand(a, a.shape) for a in pt]
    sc = _operand(scalars, scalars.shape)
    err = _lib().sczk_g1_scalar_mul(*_ptrs(P), sc.data_ptr(), n_limbs, m, *_ptrs(out),
                                    g1_consts(spec).ctypes.data, _stream(sc))
    scalar_mul.launches += 1
    cuda_build.check(err, "g1 scalar_mul")
    return out


def _broadcast_scalars(pt: tuple, scalars: torch.Tensor):
    shape = torch.broadcast_shapes(pt[0].shape[:-1], scalars.shape[:-1])
    return (tuple(a.expand(shape + a.shape[-1:]) for a in pt),
            scalars.expand(shape + scalars.shape[-1:]))


def horner(spec: FieldSpec, totals: tuple, c: int) -> tuple:
    """sum_w 2^(c*w) T_w over totals [W, C] -> [C]: kernel on CUDA, plain on the CPU."""
    if _on_cpu(*totals):
        return horner_plain(spec, totals, c)
    _check(spec, *totals)
    W, C = totals[0].shape[0], totals[0].shape[1]
    tot = [_operand(a, a.shape) for a in totals]
    out = _empty(spec, (C,), tot[0].device)
    err = _chain_lib().sczk_g1_horner(*_ptrs(tot), W, C, c, *_ptrs(out),
                                      g1_consts(spec).ctypes.data, _stream(tot[0]))
    horner.launches += 1
    cuda_build.check(err, "g1 horner")
    return out


def bucket_serial(spec: FieldSpec, buckets: tuple, segments: int | None = None) -> tuple:
    """sum_{k>=1} k*B_k over buckets [K, M] -> [M] on the segmented schedule
    (``segments`` per lane, default ``bucket_segments(K, M)``): kernel on
    CUDA, plain on the CPU."""
    if _on_cpu(*buckets):
        return bucket_serial_plain(spec, buckets, segments)
    _check(spec, *buckets)
    K, M = buckets[0].shape[0], buckets[0].shape[1]
    S = _segments(K, M, segments)
    b = [_operand(a, a.shape) for a in buckets]
    out = _empty(spec, (M,), b[0].device)
    err = _chain_lib().sczk_g1_bucket_serial(*_ptrs(b), K, M, S, *_ptrs(out),
                                             g1_consts(spec).ctypes.data, _stream(b[0]))
    bucket_serial.launches += 1
    cuda_build.check(err, "g1 bucket_serial")
    return out


def fq_mul_cc(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 over int32 [m, 24] Fq operands on the card by the
    low-latency product of csrc/fq_chain.cuh that Horner and bucket-serial
    run on (a probe, to hold it against ``cuda_fr.mul``'s fmul)."""
    _check(spec, a, b)
    if a.shape != b.shape or a.dim() != 2 or a.shape[-1] != spec.num_limbs:
        raise ValueError(f"operands {tuple(a.shape)} and {tuple(b.shape)}, want [m, 24] each")
    a, b = _operand(a, a.shape), _operand(b, b.shape)
    out = torch.empty_like(a)
    if a.shape[0]:
        cuda_build.check(_chain_lib().sczk_fq_mul_cc(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                                     a.shape[0], g1_consts(spec).ctypes.data,
                                                     _stream(a)), "fq_mul_cc")
    return out


def fq_mul_cc_chain(spec: FieldSpec, xy: torch.Tensor, n: int) -> torch.Tensor:
    """x * y^n * R^-n by n dependent products of csrc/fq_chain.cuh in one
    thread (``fq_mul_chain``'s probe for the low-latency product)."""
    _check(spec, xy)
    xy = _operand(xy, xy.shape)
    out = torch.empty(spec.num_limbs, dtype=torch.int32, device=xy.device)
    cuda_build.check(_chain_lib().sczk_fq_mul_cc_chain(xy.data_ptr(), n, out.data_ptr(),
                                                       g1_consts(spec).ctypes.data, _stream(xy)),
                     "fq_mul_cc chain")
    return out


def fq_mul_chain(spec: FieldSpec, xy: torch.Tensor, n: int) -> torch.Tensor:
    """x * y^n * R^-n by n dependent Montgomery products in one thread, for
    ``xy`` [2, 24] on the card: what one Fq product of csrc/fr.cuh costs in
    a single thread (a diagnostic; the chain bounds use ``imad_chain``)."""
    _check(spec, xy)
    xy = _operand(xy, xy.shape)
    out = torch.empty(spec.num_limbs, dtype=torch.int32, device=xy.device)
    cuda_build.check(_lib().sczk_fq_mul_chain(xy.data_ptr(), n, out.data_ptr(),
                                              g1_consts(spec).ctypes.data, _stream(xy)),
                     "fq mul chain")
    return out


def imad_chain(xy: torch.Tensor, n: int) -> torch.Tensor:
    """c = lo(c) * y + c mod 2^64, n times from c = x, in one thread, for
    ``xy`` int32 [2] on the card (the bits of uint32 x, y): a probe of one
    dependent 32x32->64 multiply-add's latency.  Returns c's bits, int64 [1]."""
    if xy.device.type != "cuda" or xy.dtype != torch.int32 or xy.shape != (2,):
        raise TypeError(f"imad_chain takes a CUDA int32 [2], got {xy.device} {xy.dtype} "
                        f"{tuple(xy.shape)}")
    xy = xy.contiguous()
    out = torch.empty(1, dtype=torch.int64, device=xy.device)
    cuda_build.check(_lib().sczk_imad_chain(xy.data_ptr(), n, out.data_ptr(), _stream(xy)),
                     "imad chain")
    return out


def attributes(name: str) -> dict:
    """Registers and spill (local) bytes per thread of a kernel, from the card."""
    out = np.zeros(2, dtype=np.int32)
    if name in CHAIN_ATTR_KERNELS:
        err = _chain_lib().sczk_g1_chain_attrs(CHAIN_ATTR_KERNELS.index(name), out.ctypes.data)
    else:
        err = _lib().sczk_g1_attrs(ATTR_KERNELS.index(name), out.ctypes.data)
    cuda_build.check(err, f"g1 attributes of {name}")
    return {"registers": int(out[0]), "spill_bytes": int(out[1])}


# The plain version of each wrapper, with the wrapper's arguments and result.
add.plain = lambda spec, p1, p2: add_plain(spec, *_broadcast(p1, p2))[0]  # noqa: E731
add_mixed.plain = lambda spec, p1, p2: add_plain(  # noqa: E731
    spec, *_broadcast(p1, p2), mixed=True)[0]
double.plain = double_plain
add_masked.plain = lambda spec, p1, p2, valid: masked_plain(  # noqa: E731
    spec, p1, p2, valid, keep_first=True)
add_reset.plain = lambda spec, p1, p2, same: masked_plain(  # noqa: E731
    spec, p1, p2, same, keep_first=False)
accumulate.plain = lambda spec, *args: accumulate_plain(spec, *args)[0]  # noqa: E731
scalar_mul.plain = lambda spec, pt, scalars: scalar_mul_plain(  # noqa: E731
    spec, *_broadcast_scalars(pt, scalars))
horner.plain = horner_plain
bucket_serial.plain = bucket_serial_plain

add.launches = add_mixed.launches = double.launches = 0
add_masked.launches = add_reset.launches = 0
accumulate.launches = 0
accumulate.repaired = DoubledSteps()
scalar_mul.launches = horner.launches = bucket_serial.launches = 0
