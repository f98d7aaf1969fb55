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
    """The accumulate's output at every step against the JAX package's
    scan body (``add_mixed_reset_lazy`` and the repair of flagged lanes,
    msm.py:467-479) on the same entries: three lanes of four steps over
    the table (A, B, A + B, C, infinity) that meet an x-collision with a
    Jacobian and with an affine accumulator, a cancelling pair, infinity
    on either side, key changes and one padding entry."""
    A, B, C = _host_points(3, 13)
    table = [A, B, hc.g1_add(A, B), C, None]
    keys = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 3]
    pid = [0, 1, 2, 2, 0, 0, 4, 3, 3, 3, 4]
    neg = [0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0]
    lanes, steps, pad = 3, 4, 1
    got, doubled = cuda_g1.accumulate(T.fq.spec, torch.tensor(keys), torch.tensor(pid),
                                      torch.tensor(neg, dtype=torch.bool),
                                      T.from_affine_ints(table), lanes, steps)
    assert doubled == 2  # lane 0 at step 2, lane 1 at step 1

    jt = J.from_affine_ints(table)
    pts = jg1.PointJ(*(a[jnp.asarray(pid + [4] * pad)] for a in jt))  # padding: infinity
    pts = J.select(jnp.asarray(neg + [0] * pad, bool), J.neg(pts), pts)
    k = np.array(keys + [cuda_g1.SENTINEL] * pad, dtype=np.int64).reshape(lanes, steps).T
    pts = jg1.PointJ(*(a.reshape(lanes, steps, -1).swapaxes(0, 1) for a in pts))
    acc, prev = J.infinity((lanes,)), np.full(lanes, cuda_g1.SENTINEL)
    for s in range(steps):
        out, flag = J.add_mixed_reset_lazy(acc, jg1.PointJ(*(a[s] for a in pts)),
                                           jnp.asarray(k[s] == prev))
        acc = J.select(flag, J.double(acc), out)
        prev = k[s]
        _eq(PointJ(*(a[s] for a in got)), acc)


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


def test_plain_horner_and_bucket_serial_vs_host(curves):
    """The plain Horner (sum_w 2^(c w) T_w) and bucket-serial (sum_k k B_k)
    against Python-int arithmetic, with infinities among the inputs."""
    T, _ = curves
    spec = T.fq.spec
    host = _host_points(12, 11)
    host[4] = None
    pts = T.from_affine_ints(host)
    W, C, c = 4, 3, 3
    tot = PointJ(*(a.reshape(W, C, -1) for a in pts))
    got = T.to_affine_ints(PointJ(*cuda_g1.horner(spec, tot, c)))
    assert got == [_host_sum((host[w * C + j], 1 << (c * w)) for w in range(W)) for j in range(C)]
    K, M = 6, 2
    buckets = PointJ(*(a.reshape(K, M, -1) for a in pts))
    got = T.to_affine_ints(PointJ(*cuda_g1.bucket_serial(spec, buckets)))
    assert got == [_host_sum((host[k * M + j], k) for k in range(1, K)) for j in range(M)]
