"""Port parity: the dense MSM core at a fixed window width.

``_msm_1d_dense`` (the JAX package's flat entry, which its oracle tests
call) and ``_msm_ragged_dense`` at a caller's c, with the digits and the
bucket-serial schedule they rest on.  The same seeded points and scalars
go through the JAX package (its native CPU kernels under ``jax.jit``) and
the port (the plain versions of its kernels, on the CPU); G1 results are
compared by affine value, digits and schedules as exact integers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu.fields.config import int_to_limbs
from scalable_collaborative_zksnark_tpu.primitives import msm as jmsm
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1, map_points
from scalable_collaborative_zksnark_tpu_torch.primitives import msm

N = 280  # tests/test_msm.py::test_dense_msm_vs_oracle's size and sets


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions run many tiny tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curves():
    return bls12_381_g1("cpu"), jg1.bls12_381_g1()


def _limbs(values) -> np.ndarray:
    return np.stack([int_to_limbs(int(v), 16) for v in values])


def _port(pt) -> PointJ:
    return convert.points_from_numpy([np.asarray(a) for a in pt], "cpu")


def _affine(curve, pt):
    """Affine value of a point (PointJ [] or [n])."""
    if pt.x.ndim == 1:
        pt = map_points(lambda a: a[None], pt)
    return curve.to_affine_ints(pt)


def _jax_affine(J, pt):
    if pt.x.ndim == 1:
        pt = jax.tree.map(lambda a: a[None], pt)
    return J.to_affine_ints(pt)


@pytest.fixture(scope="module")
def data(curves):
    """test_dense_msm_vs_oracle's set: 280 points k_i G with an infinity
    (index 3) and a duplicate (9 = 10); scalars ``si`` with a zero (index
    5), and ``skew``, every scalar from index 2 on equal (one bucket a
    window holds 278 entries)."""
    _, J = curves
    r = J.fr.p
    ks = [(5 * i * i + 11) % r for i in range(1, N + 1)]
    host = J.to_affine_ints(J.scalar_mul_int(J.from_affine_ints([hc.G1_GEN] * N), ks))
    host[3] = None
    host[9] = host[10]
    si = [(13 * i * i * i + 7) % r for i in range(N)]
    si[5] = 0
    skew = si[:2] + [si[1]] * (N - 2)
    return J.from_affine_ints(host), {"si": _limbs(si), "skew": _limbs(skew)}


def _jax_msm(J, pts, sc):
    return jax.jit(lambda p, s: jmsm.msm(J, p, s))(pts, jnp.asarray(sc))


def _spy(monkeypatch, name):
    """Record the arguments of every call to ``msm.<name>``."""
    calls, fn = [], getattr(msm, name)

    def spy(*args):
        calls.append(args)
        return fn(*args)
    monkeypatch.setattr(msm, name, spy)
    return calls


def test_digits_match_jax():
    """``_digit`` of every window at c = 2 .. 13 (a window straddling two
    limbs, the top window past bit 255) on 0, 1, r - 1, 2^256 - 1 and
    random scalars equals the JAX package's."""
    rng = np.random.RandomState(5)
    vals = [0, 1, hc.R - 1, (1 << 256) - 1] + [int.from_bytes(rng.bytes(32), "little")
                                               for _ in range(12)]
    sc = _limbs(vals)
    t = convert.from_numpy(sc, "cpu").to(torch.int64)
    for c in (2, 3, 4, 5, 6, 8, 9, 13):
        for w in range(-(-256 // c)):
            want = np.asarray(jmsm._digit(jnp.asarray(sc), c, jnp.uint32(w)))
            assert msm._digit(t, c, w).tolist() == want.tolist(), (c, w)


def test_bucket_schedule_fits_every_pick():
    """At every (c, lanes) the cost model picks, bucket-serial's segments
    fit its kernel over the K = 2^(c-1) + 1 signed buckets: 1 <= S <= 64
    and S segments of ceil((K - 1) / S) cover buckets 1 .. K - 1."""
    for total in (1, 40, 300, 1000, 3 * 1024, 3 * 8192, 24573, 1 << 20):
        for segs in (1, 2, 3, 21, 39, 100):
            for nbits in (32, 256):
                c = msm._pick_c_dense(total, segs, nbits)
                K, M = (1 << (c - 1)) + 1, -(-nbits // c) * segs
                S = cuda_g1.bucket_segments(K, M)
                assert 1 <= S <= cuda_g1.MAX_SEGMENTS, (total, segs, nbits)
                assert S * -(-(K - 1) // S) >= K - 1, (total, segs, nbits)


def test_dense_msm_fixed_c(curves, data, monkeypatch):
    """``_msm_1d_dense`` at c = 4 (not the cost model's c) on both scalar
    sets of N = 280 equals the JAX package's ``msm``; the accumulate walks
    K = 2^3 + 1 signed buckets in each of the 64 windows."""
    T, J = curves
    pts, sets = data
    P = _port(pts)
    seen = _spy(monkeypatch, "_dense_bucket_sums")
    for name, sc in sets.items():
        got = msm._msm_1d_dense(T, P, convert.from_numpy(sc, "cpu"), 4)
        assert _affine(T, got) == _jax_affine(J, _jax_msm(J, pts, sc)), name
    assert [args[-1].shape for args in seen] == [(64 * 9,)] * 2


def test_chunked_dense_core_top_window(curves, data, monkeypatch):
    """Windows in chunks (MAX_DENSE_ENTRIES exceeded): 52 windows of c = 5
    over 40 entries as chunks of 25, 25 and 2, the signed-digit carry
    crossing them, on four segments of 10 points, whose 208 (window,
    segment) lanes take the bucket-serial reduce over K = 17 buckets.  The
    scalars r - 1 - i set the top bits, so the top window (bits 255 ..
    259) takes the carry out of window 50."""
    T, J = curves
    pts, _ = data
    jp = J.normalize(jax.tree.map(lambda a: a[:40], pts))
    sc = _limbs([hc.R - 1 - i for i in range(40)])
    monkeypatch.setattr(msm, "MAX_DENSE_ENTRIES", 1000)
    seen = _spy(monkeypatch, "_dense_bucket_sums")
    grids = _spy(monkeypatch, "_weighted_bucket_totals")
    got = msm._msm_ragged_dense(T, _port(jp), convert.from_numpy(sc, "cpu"), (10,) * 4, 5, True)
    want = [_jax_affine(J, _jax_msm(J, jax.tree.map(lambda a: a[s], jp), sc[s]))[0]
            for s in (slice(k, k + 10) for k in range(0, 40, 10))]
    assert T.to_affine_ints(got) == want
    assert [len(args[-1]) // (4 * 17) for args in seen] == [25, 25, 2]
    (_, acc), = grids
    assert acc.x.shape[:3] == (52, 4, 17) and 52 * 4 >= msm.SERIAL_REDUCE_MIN_LANES
