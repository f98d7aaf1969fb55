"""Port parity: the G1 group law, scalar multiplication, PSS over G1, and
the plain versions of the Horner and bucket-serial kernels.

Same seeded points through the JAX package and the port (its plain
versions, on the CPU).  The JAX package's ``add``, ``add_mixed``,
``double`` and ``add_mixed_reset_lazy`` run their plain jnp formulas on the
CPU and are compared bit for bit in Jacobian limbs (the last through the
scan the port's accumulate replaces).  Its ``scalar_mul``,
``sum`` and ``linear_map`` run the native CPU kernels there, which return
other Jacobian representatives, so those are compared by affine value.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu.fields.config import int_to_limbs
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams
from scalable_collaborative_zksnark_tpu_torch.scripts import chain_bench


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions run many tiny tensor ops,
    which more threads slow down, and the suite's parallel workers would
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curves():
    return bls12_381_g1("cpu"), jg1.bls12_381_g1()


def _port(pt) -> PointJ:
    return convert.points_from_numpy([np.asarray(a) for a in pt], "cpu")


def _eq(got, want):
    for a, b in zip(convert.points_to_numpy(got), want, strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def _host_points(n, seed):
    return [hc.g1_mul(hc.G1_GEN, seed * i * i + i + 2) for i in range(1, n + 1)]


@pytest.fixture(scope="module")
def case_points(curves):
    """JAX points p1, p2 with Z != 1 (doubled from affine), lane by lane:
    an equal pair, a cancelling pair, infinity on the right, infinity on
    the left, then random points; a2 is p2 in affine form."""
    _, J = curves
    h1, h2 = _host_points(9, 3), _host_points(9, 7)
    h2[0] = h1[0]
    h2[1] = (h1[1][0], (-h1[1][1]) % hc.P)
    h2[2] = None
    h1[3] = None
    # doubling is a bijection here: the cases survive it
    p1 = J.double(J.from_affine_ints(h1))
    p2 = J.double(J.from_affine_ints(h2))
    return p1, p2, J.normalize(p2)


def _accumulate_vs_jax_scan(T, J):
    """The accumulate's bucket sums against the JAX package's scan body
    (``add_mixed_reset_lazy`` and the repair of flagged lanes,
    msm.py:467-479) on the same entries, at each bucket's last entry:
    three lanes of four steps over the table (A, B, A + B, C, infinity)
    that meet an x-collision with a Jacobian and with an affine
    accumulator, a cancelling pair, infinity on either side, key changes
    and one padding entry; bucket 0 (digit 0) holds no entry."""
    A, B, C = _host_points(3, 13)
    table = [A, B, hc.g1_add(A, B), C, None]
    keys = [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 4]
    pid = [0, 1, 2, 2, 0, 0, 4, 3, 3, 3, 4]
    neg = [0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0]
    lanes, steps, pad = 3, 4, 1
    before = int(cuda_g1.accumulate.repaired)
    got = cuda_g1.accumulate(T.fq.spec, torch.tensor(keys), torch.tensor(pid),
                             torch.tensor(neg, dtype=torch.bool), T.from_affine_ints(table),
                             lanes, 5, 5)
    assert int(cuda_g1.accumulate.repaired) - before == 2  # lane 0 at step 2, lane 1 at step 1

    jt = J.from_affine_ints(table)
    pts = jg1.PointJ(*(a[jnp.asarray(pid + [4] * pad)] for a in jt))  # padding: infinity
    pts = J.select(jnp.asarray(neg + [0] * pad, bool), J.neg(pts), pts)
    k = np.array(keys + [cuda_g1.SENTINEL] * pad, dtype=np.int64).reshape(lanes, steps).T
    pts = jg1.PointJ(*(a.reshape(lanes, steps, -1).swapaxes(0, 1) for a in pts))
    acc, prev = J.infinity((lanes,)), np.full(lanes, cuda_g1.SENTINEL)
    ends = {(3, 0): 1, (1, 1): 2, (3, 1): 3, (2, 2): 4}  # (step, lane): the bucket ending there
    for s in range(steps):
        out, flag = J.add_mixed_reset_lazy(acc, jg1.PointJ(*(a[s] for a in pts)),
                                           jnp.asarray(k[s] == prev))
        acc = J.select(flag, J.double(acc), out)
        prev = k[s]
        for lane in range(lanes):
            if (s, lane) in ends:
                _eq(PointJ(*(a[ends[s, lane]] for a in got)), jg1.PointJ(*(a[lane] for a in acc)))
    _eq(PointJ(*(a[0] for a in got)), J.infinity(()))


@pytest.mark.parametrize("op", ["add", "add_mixed", "double", "add_mixed_reset_lazy"])
def test_group_law_bit_exact(curves, case_points, op):
    T, J = curves
    p1, p2, a2 = case_points
    if op == "add":
        want, got = J.add(p1, p2), T.add(_port(p1), _port(p2))
    elif op == "add_mixed":
        want, got = J.add_mixed(p1, a2), T.add_mixed(_port(p1), _port(a2))
    elif op == "double":
        want, got = J.double(p1), T.double(_port(p1))
    else:  # the accumulate kernel replaces the JAX scan over add_mixed_reset_lazy
        _accumulate_vs_jax_scan(T, J)
        return
    _eq(got, want)
    if op == "add":  # the cases took their branches: 2 P, infinity, p1, p2
        aff = T.to_affine_ints(got)
        h1 = J.to_affine_ints(p1)
        assert aff[0] == hc.g1_add(h1[0], h1[0]) and aff[1] is None
        assert aff[2] == h1[2] and aff[3] == J.to_affine_ints(p2)[3]


def _scalars(values, n_limbs):
    return np.stack([int_to_limbs(v, n_limbs) for v in values])


def test_scalar_mul(curves, case_points):
    """Scalars 0, 1, r - 1 and full-width random ones through ``scalar_mul``
    and ``scalar_mul_int``; 2-limb scalars through ``scalar_mul``."""
    T, J = curves
    p1 = case_points[0]
    rng = np.random.RandomState(21)
    r = J.fr.p
    ks = [0, 1, r - 1] + [int.from_bytes(rng.bytes(32), "little") % r for _ in range(6)]
    want = J.to_affine_ints(J.scalar_mul_int(p1, ks))
    P = _port(p1)
    assert T.to_affine_ints(T.scalar_mul_int(P, ks)) == want
    assert want[0] is None and want[1] == J.to_affine_ints(p1)[1]
    k2 = [int(v) for v in rng.randint(0, 1 << 32, size=9, dtype=np.uint64)]
    got = T.scalar_mul(P, torch.from_numpy(_scalars(k2, 2).view(np.int32)))
    host = J.to_affine_ints(p1)
    assert T.to_affine_ints(got) == [None if h is None else hc.g1_mul(h, k)
                                     for h, k in zip(host, k2)]


def test_normalize_neg_select_sum(curves, case_points):
    T, J = curves
    p1, p2, _ = case_points
    P1, P2 = _port(p1), _port(p2)
    _eq(T.normalize(P1), J.normalize(p1))  # canonical: bit-exact
    _eq(T.normalize(PointJ(*(a.reshape(3, 3, -1) for a in P1))),
        J.normalize(PointJ(*(a.reshape(3, 3, -1) for a in p1))))
    _eq(T.neg(P1), J.neg(p1))
    cond = np.arange(9) % 2 == 0
    _eq(T.select(torch.from_numpy(cond), P1, P2), J.select(jnp.asarray(cond), p1, p2))
    assert T.to_affine_ints(T.sum(P1)) == J.to_affine_ints(J.sum(p1))
    grid = PointJ(*(a.reshape(3, 3, -1) for a in P1))
    jgrid = PointJ(*(a.reshape(3, 3, -1) for a in p1))
    assert T.to_affine_ints(T.sum(grid, axis=-1)) == J.to_affine_ints(J.sum(jgrid, axis=-1))
    assert T.to_affine_ints(P1) == J.to_affine_ints(p1)


def test_equal_and_is_on_curve(curves, case_points):
    T, J = curves
    p1, p2, _ = case_points
    P1, P2 = _port(p1), _port(p2)
    for a, b, ja, jb in ((P1, P2, p1, p2), (P1, T.normalize(P1), p1, J.normalize(p1))):
        np.testing.assert_array_equal(T.equal(a, b).numpy(), np.asarray(J.equal(ja, jb)))
    assert T.equal(P1, T.normalize(P1)).all()
    assert T.is_on_curve(P1).all()
    off = PointJ(T.fq.add(P1.x, T.fq.ones(P1.x.shape[:-1])), P1.y, P1.z)
    joff = PointJ(J.fq.add(p1.x, J.fq.ones(p1.x.shape[:-1])), p1.y, p1.z)
    got = T.is_on_curve(off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.is_on_curve(joff)))
    assert got.tolist() == [False, False, False, True] + [False] * 5  # lane 3 is infinity


@pytest.mark.parametrize("method", ["pack_from_public_group", "unpack_group", "unpack2_group"])
def test_pss_group_methods(curves, method):
    """``linear_map`` through the three PSS group methods at l = 2 (the
    pack on a [2, l] batch)."""
    T, J = curves
    pp, jpp = PackedSharingParams(T.fr, 2), JaxPSS(J.fr, 2)
    n_in = pp.l if method == "pack_from_public_group" else pp.n
    batch = (2,) if method == "pack_from_public_group" else ()
    count = int(np.prod(batch, dtype=np.int64)) * n_in
    jp = J.from_affine_ints(_host_points(count, 5))
    jp = PointJ(*(a.reshape(batch + (n_in, -1)) for a in jp))
    want = J.to_affine_ints(getattr(jpp, method)(J, jp))
    assert T.to_affine_ints(getattr(pp, method)(T, _port(jp))) == want


def _host_sum(points_and_scalars):
    acc = None
    for p, k in points_and_scalars:
        acc = hc.g1_add(acc, hc.g1_mul(p, k) if p is not None else None)
    return acc


def _running_suffix(spec, buckets):
    """sum_{k>=1} k B_k by the running suffix alone, the schedule the
    bucket-serial kernel ran before it was segmented: acc = B_{K-1},
    total = acc; for k = K-2 .. 1: acc += B_k, total += acc."""
    K = buckets[0].shape[0]
    acc = tuple(a[K - 1] for a in buckets)
    total = acc
    for k in range(K - 2, 0, -1):
        acc = cuda_g1.add_plain(spec, acc, tuple(a[k] for a in buckets))[0]
        total = cuda_g1.add_plain(spec, total, acc)[0]
    return total


# (K, M, segments, edits): edits set bucket (k, m) of the host grid to
# None (infinity) or to a copy (or the negated double) of another cell
BUCKET_CASES = {
    "running_suffix": (6, 2, 1, {}),
    "segments": (17, 3, 4, {}),
    "ragged_segments": (12, 2, 3, {}),
    "k2": (2, 3, None, {}),
    "empty_buckets": (9, 3, 2, {(2, 0): None, (5, 0): None, (8, 1): None,
                                **{(k, 2): None for k in range(9)}}),
    "equal_buckets": (9, 2, 2, {(8, 0): ("copy", 7, 0), (4, 1): ("copy", 3, 1),
                                (2, 1): ("negdouble", 3, 1)}),
    "default_segments": (33, 4, None, {}),
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_plain_horner_and_bucket_serial_vs_host(curves, case):
    """The plain Horner (sum_w 2^(c w) T_w) and bucket-serial (sum_k k B_k,
    on the segmented schedule) against Python-int arithmetic, with
    infinities among the inputs; bucket shapes with one segment (then also
    bit-equal to the running suffix), several, K - 1 not a multiple of S,
    K = 2, empty buckets and an all-empty lane, and equal buckets, where
    the suffix doubles (and then cancels)."""
    T, _ = curves
    spec = T.fq.spec
    host = _host_points(12, 11)
    host[4] = None
    pts = T.from_affine_ints(host)
    W, C, c = 4, 3, 3
    tot = PointJ(*(a.reshape(W, C, -1) for a in pts))
    got = T.to_affine_ints(PointJ(*cuda_g1.horner(spec, tot, c)))
    assert got == [_host_sum((host[w * C + j], 1 << (c * w)) for w in range(W)) for j in range(C)]
    K, M, S, edits = BUCKET_CASES[case]
    grid = _host_points(K * M, 13)
    for (k, m), e in edits.items():
        if e is None:
            grid[k * M + m] = None
        else:
            src = grid[e[1] * M + e[2]]
            grid[k * M + m] = src if e[0] == "copy" else hc.g1_neg(hc.g1_add(src, src))
    buckets = PointJ(*(a.reshape(K, M, -1) for a in T.from_affine_ints(grid)))
    out = cuda_g1.bucket_serial(spec, buckets, S)
    assert T.to_affine_ints(PointJ(*out)) == [
        _host_sum((grid[k * M + j], k) for k in range(1, K)) for j in range(M)]
    if (S or cuda_g1.bucket_segments(K, M)) == 1:
        for a, b in zip(out, _running_suffix(spec, buckets), strict=True):
            assert torch.equal(a, b)


def test_bucket_segments():
    """One segment where segmenting cannot shorten a lane's chain or the
    lanes already fill the card; a power of two up to 64 otherwise, with
    M * S within the fill; 4 at the prove's open-chain shape (K 33,
    1,677 lanes), where the chain is 25 point ops against 62."""
    seg = cuda_g1.bucket_segments
    assert seg(2, 5) == seg(3, 100) == 1
    assert seg(33, cuda_g1.SEGMENT_FILL_THREADS) == 1
    assert seg(33, 1677) == 4 and seg(129, 300) == 8
    for K in (5, 9, 17, 33, 129, 2049):
        for M in (1, 192, 1677, 5000):
            S = seg(K, M)
            assert S & (S - 1) == 0 and S <= cuda_g1.MAX_SEGMENTS
            assert S == 1 or M * S <= cuda_g1.SEGMENT_FILL_THREADS


def test_chain_bench_on_cpu(capsys):
    """``scripts/chain_bench.py`` at tiny shapes through the plain versions:
    one JSON object with a time per point-add lane count (host time only:
    no device time on the CPU), per masked-add lane count and share, per
    ladder lanes and limbs, per accumulate call (the one a ragged MSM
    over levels 8, 4, 2, 1 makes, with its shape), per Horner shape and
    per bucket shape and segment count, per fold-phase shape, per
    elementwise op at the prove's shapes and at each ``--elementwise``
    size, per point op, no product chain, empty launch or small-against-
    staged row (card-only probes) and no prove."""
    chain_bench.main(["--device", "cpu", "--horner", "3,2,2;2,1,1", "--bucket", "5,3",
                      "--segments", "1,2", "--reps", "1", "--no-prove", "--add", "3",
                      "--masked", "5,4:0.25", "--ladder", "2x1",
                      "--accumulate", "ragged:8,1", "--phase", "2,8;1,4",
                      "--elementwise", "8", "--points", "5", "--stage", "4"])
    out = json.loads(capsys.readouterr().out)
    ew = out["elementwise_ms"]
    for op, pairs in chain_bench.ELEMENTWISE_SHAPES.items():
        want = {f"bls12_381_fr {op} {list(sa)}x{list(sb)}" for sa, sb in pairs}
        want |= {f"{f} {op} [8]x[8]" for f in ("bls12_381_fr", "bls12_381_fq")}
        assert want <= set(ew)
    assert len(ew) == 15 and set(out["point_ms"]) == {"add_mixed", "double"}
    for row in (*ew.values(), *out["point_ms"].values()):
        assert row["device"] is None and row["events"] > 0
    assert out["stage_ms"] == {} and "empty_launch_ms" not in out
    assert set(out["phase_ms"]) == {"2,8", "1,4"} and out["fr_chain_us"] == {}
    assert all(r["device"] is None and r["events"] > 0 for r in out["phase_ms"].values())
    assert out["card"] == "cpu" and set(out["horner_ms"]) == {"3,2,2", "2,1,1"}
    assert set(out["add_ms"]) == {"3"} and out["add_ms"]["3"]["device"] is None
    assert out["add_ms"]["3"]["events"] > 0
    assert set(out["masked_ms"]) == {"5:0.5", "4:0.25"} and set(out["ladder_ms"]) == {"2x1"}
    for row in (*out["masked_ms"].values(), out["ladder_ms"]["2x1"]):
        assert row["device"] is None and row["events"] > 0
    acc = out["accumulate_ms"]["ragged:8,1"]
    E, T, steps, NB = acc["shape"]
    assert acc["events"] > 0 and acc["device"] is None and 0 < E <= T * steps < E + T
    assert T == cuda_g1.accumulate_lanes(E, "cpu") and NB > 0
    row = out["bucket_serial_ms"]["5,3"]
    assert set(row) == {"default", "default_segments", "S=1", "S=2"}
    assert row["default_segments"] == cuda_g1.bucket_segments(5, 3)
    assert out["fq_chain_us"] == {} and "prove_median_s" not in out
