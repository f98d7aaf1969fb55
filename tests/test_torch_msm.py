"""Port parity: the dense signed-digit MSM, msm_ragged and d_msm.

Same seeded points and scalars through the JAX package (its native CPU
kernels, which return other Jacobian representatives) and the port (the
plain versions of its kernels, on the CPU); results are compared by
affine value, and the party-net counters exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import chip_smoke
from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu.fields.config import int_to_limbs
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu.primitives import msm as jmsm
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import msm
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams
from scalable_collaborative_zksnark_tpu_torch.utils.digest import point_digest

N = 300


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


def _limbs(values) -> np.ndarray:
    arr = np.asarray(values, dtype=object)
    return np.stack([int_to_limbs(int(v), 16) for v in arr.reshape(-1)]).reshape(arr.shape + (16,))


@pytest.fixture(scope="module")
def data(curves):
    """N bases (JAX PointJ, Z != 1) with two infinities, the first two
    equal and a run of three equal points; scalars [3, N] (numpy limbs):
    random with zeros and r - 1, all equal (every entry lands in one
    bucket per window, which starts with the two equal points), and
    r - 1 - i (the top window must not carry out)."""
    _, J = curves
    rng = np.random.RandomState(11)
    r = J.fr.p
    host = J.to_affine_ints(J.scalar_mul_int(J.from_affine_ints([hc.G1_GEN] * N),
                                             [int(k) for k in rng.randint(1, 1 << 30, size=N)]))
    host[5] = host[17] = None
    host[1] = host[0]
    host[21] = host[22] = host[20]
    pts = J.double(J.from_affine_ints(host))
    rand = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(N)]
    rand[3] = rand[40] = 0
    rand[7] = r - 1
    one = int.from_bytes(rng.bytes(32), "little") % r
    scal = _limbs([rand, [one] * N, [r - 1 - i for i in range(N)]])
    return pts, scal


@pytest.mark.parametrize("n", [40, N])
def test_msm_naive_and_dense(curves, data, n):
    """N = 40 runs the double-and-add branch, N = 300 the dense core;
    three scalar rows share the bases.  The all-equal row starts a bucket
    of every window with two equal points, so the accumulate doubles."""
    T, J = curves
    pts, scal = data
    jp = jax.tree.map(lambda a: a[:n], pts)
    sc = scal[:, :n]
    before = cuda_g1.accumulate.repaired
    got = msm.msm(T, _port(jp), convert.from_numpy(sc, "cpu"))
    assert T.to_affine_ints(got) == J.to_affine_ints(jmsm.msm(J, jp, jnp.asarray(sc)))
    if n > msm.NAIVE_MAX:
        assert cuda_g1.accumulate.repaired > before


@pytest.mark.parametrize("gate", ["prefix_scan", "bucket_serial"])
def test_msm_ragged(curves, data, gate):
    """Below the 192-lane gate: two entries of 300 and 100 points, batch 1;
    above it: a halving chain 64 .. 1, batch 3 (21 segments)."""
    T, J = curves
    pts, scal = data
    sizes, batch = ([N, 100], 1) if gate == "prefix_scan" else ([64 >> k for k in range(7)], 3)
    bases = [jax.tree.map(lambda a, n=n: a[:n], pts) for n in sizes]
    scals = [scal[:batch, :n] for n in sizes]
    c = msm._pick_c_dense(batch * sum(sizes), batch * len(sizes))
    lanes = -(-256 // c) * batch * len(sizes)
    assert (lanes >= msm.SERIAL_REDUCE_MIN_LANES) == (gate == "bucket_serial")
    got = msm.msm_ragged(T, [_port(b) for b in bases],
                         [convert.from_numpy(s, "cpu") for s in scals])
    want = jmsm.msm_ragged(J, bases, [jnp.asarray(s) for s in scals])
    assert [T.to_affine_ints(g) for g in got] == [J.to_affine_ints(w) for w in want]


@pytest.mark.parametrize("config", ["dense", "nondense"])
def test_msm_ragged_per_party_bases(curves, data, monkeypatch, config):
    """Per-party bases [P, N_i] align as prefixes of scalars [P, B, N_i]
    (a sim-mode c_open's batched q-vectors over srs_packed's levels): each
    entry equals the JAX package's ``msm`` of its party's bases, on the
    dense core and on the non-dense cores (``SCZK_MSM_DENSE=0``)."""
    T, J = curves
    pts, scal = data
    if config == "nondense":
        monkeypatch.setenv("SCZK_MSM_DENSE", "0")
    P, B, sizes = 2, 3, (8, 4)
    bases = [jax.tree.map(lambda a, n=n, o=o: a[o:o + P * n].reshape(P, n, -1), pts)
             for n, o in zip(sizes, (0, 40))]
    scals = [np.stack([scal[:B, 50 * p:50 * p + n] for p in range(P)]) for n in sizes]
    got = msm.msm_ragged(T, [_port(b) for b in bases],
                         [convert.from_numpy(s, "cpu") for s in scals])
    want = [jmsm.msm(J, b, jnp.asarray(s)) for b, s in zip(bases, scals)]
    assert [T.to_affine_ints(g) for g in got] == [J.to_affine_ints(w) for w in want]


def test_chunked_dense_core(curves, data, monkeypatch):
    """Windows in chunks (MAX_DENSE_ENTRIES exceeded): 64 windows of c = 4
    over 40 entries run as chunks of 25, 25 and 14, with the signed-digit
    carry crossing chunks."""
    T, J = curves
    pts, scal = data
    jp = J.normalize(jax.tree.map(lambda a: a[:40], pts))
    monkeypatch.setattr(msm, "MAX_DENSE_ENTRIES", 1000)
    got = msm._msm_ragged_dense(T, _port(jp), convert.from_numpy(scal[0, :40], "cpu"),
                                (25, 15), 4, True)
    want = [J.to_affine_ints(jmsm.msm(J, jax.tree.map(lambda a: a[s], jp),
                                      jnp.asarray(scal[0, s])))[0]
            for s in (slice(0, 25), slice(25, 40))]
    assert T.to_affine_ints(got) == want


def test_forced_x_collision_is_repaired(curves):
    """One lane walks buckets that hold P twice in a row: the accumulate
    doubles in place of the lazy flag and its repair, and each bucket's
    last entry holds its sum.  Two lanes of four steps, padding included."""
    T, _ = curves
    host = [hc.g1_mul(hc.G1_GEN, k) for k in (3, 5, 7, 11)]
    bases = T.from_affine_ints(host)
    keys = torch.tensor([0, 0, 1, 1, 1, 2, 2], dtype=torch.int64)
    pid = torch.tensor([0, 0, 1, 2, 1, 3, 3], dtype=torch.int64)
    neg = torch.tensor([False, False, False, False, True, True, True])
    before = cuda_g1.accumulate.repaired
    scanned, doubled = cuda_g1.accumulate(T.fq.spec, keys, pid, neg, bases, 2, 4)
    assert doubled == 2 and cuda_g1.accumulate.repaired - before == 2
    p0, p1, p2, p3 = host
    ends = T.to_affine_ints(PointJ(*(a[[1, 3, 0, 2], [0, 0, 1, 1]] for a in scanned)))
    assert ends == [hc.g1_add(p0, p0), hc.g1_add(p1, p2), hc.g1_neg(p1),
                    hc.g1_add(hc.g1_neg(p3), hc.g1_neg(p3))]
    assert T.to_affine_ints(PointJ(*(a[3, 1:] for a in scanned))) == [None]  # padding


@pytest.mark.parametrize("mode", ["leader", "sim"])
def test_d_msm(curves, mode):
    """d_msm at l = 2 (16 parties), B = 2 batch entries of 4 share points."""
    T, J = curves
    l, B, M = 2, 2, 4
    pp, jpp = PackedSharingParams(T.fr, l), JaxPSS(J.fr, l)
    net, jnet = PartyNet(pp.n, mode), JaxNet(jpp.n, mode)
    P = net.local_parties
    rng = np.random.RandomState(13)
    pts = J.from_affine_ints([hc.g1_mul(hc.G1_GEN, int(k))
                              for k in rng.randint(1, 1 << 20, size=P * B * M)])
    pts = jax.tree.map(lambda a: a.reshape(P, B, M, -1), pts)
    sc = _limbs(np.array([int.from_bytes(rng.bytes(32), "little") % J.fr.p
                          for _ in range(P * B * M)], dtype=object).reshape(P, B, M))
    got = msm.d_msm(T, pp, net, _port(pts), convert.from_numpy(sc, "cpu"))
    want = jmsm.d_msm(J, jpp, jnet, pts, jnp.asarray(sc))
    assert T.to_affine_ints(got) == J.to_affine_ints(want)
    assert (net.up, net.down, net.rounds) == (jnet.up, jnet.down, jnet.rounds)


def test_pick_c_dense_matches_jax():
    for total in (1, 40, 300, 1000, 3 * 1024, 3 * 8192, 24573, 1 << 20):
        for segs in (1, 2, 3, 21, 39, 100):
            for nbits in (32, 256):
                want = jmsm._pick_c_dense(total, segs, nbits)
                assert msm._pick_c_dense(total, segs, nbits) == want


@pytest.mark.slow
def test_d_commit_pin_on_cpu():
    """chip_smoke.py's d_commit path on the CPU (random SRS bases by
    ``srs_random``'s recipe, then ``msm`` of three 1,024-point share
    vectors) reproduces its JAX-made pin."""
    T = bls12_381_g1("cpu")
    bases = chip_smoke.rand_points_flat(T, chip_smoke.DCOMMIT["n"], chip_smoke.DCOMMIT["seeds"][0])
    assert point_digest(T, chip_smoke.d_commit(T, bases)()) == chip_smoke.PINS["d_commit"]


def _jax_rand_points_flat(J, count, seed):
    """``srs_random``'s ``rand_points_flat`` (poly_comm.py:497-517) on the JAX package."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    side = min(max(int(np.ceil(np.sqrt(count))), 1), 4096)
    rows = (count + side - 1) // side
    ka = jnp.asarray(rng.randint(1, 1 << 16, size=(side, 2)).astype(np.uint32))
    kb = jnp.asarray(rng.randint(1, 1 << 16, size=(rows, 2)).astype(np.uint32))
    g = J.from_affine_ints([hc.G1_GEN])
    A = J.scalar_mul(jax.tree.map(lambda a: jnp.broadcast_to(a, (side,) + a.shape[1:]), g), ka)
    B = J.scalar_mul(jax.tree.map(lambda a: jnp.broadcast_to(a, (rows,) + a.shape[1:]), g), kb)
    grid = J.add(jax.tree.map(lambda a: a[None], A), jax.tree.map(lambda a: a[:, None], B))
    return J.normalize(jax.tree.map(lambda a: a.reshape(rows * side, -1)[:count], grid))


@pytest.mark.slow
def test_chip_smoke_msm_pins(curves):
    """Recompute chip_smoke.py's MSM-path pins from the JAX package on the
    CPU (the same seeds, recipe and digest code); this is how they were made."""
    cs = chip_smoke
    _, J = curves
    JF = J.fr
    pins = {}
    cfg = cs.COMMIT
    bases = _jax_rand_points_flat(J, cfg["n"], cfg["seeds"][0])
    pins["commit_bases"] = point_digest(J, bases)
    jpp = JaxPSS(JF, cfg["l"])
    net = JaxNet(jpp.n, "leader")
    scal = JF.decode(JF.random((1, cfg["batch"], cfg["n"]), cfg["seeds"][1]))
    pins["c_commit"] = point_digest(J, jmsm.d_msm(J, jpp, net, bases, scal))
    pins["c_commit_comm"] = cs._comm(net)
    cfg = cs.DCOMMIT
    bases = _jax_rand_points_flat(J, cfg["n"], cfg["seeds"][0])
    scal = JF.decode(JF.random((1, cfg["batch"], cfg["n"]), cfg["seeds"][1]))
    pins["d_commit"] = point_digest(J, jmsm.msm(J, bases, scal))
    cfg = cs.OPEN
    sizes = cs._open_levels(cfg)
    flat = _jax_rand_points_flat(J, sum(sizes), cfg["seeds"][0])
    scal = JF.decode(JF.random((cfg["batch"], sum(sizes)), cfg["seeds"][1]))
    offs = np.cumsum([0] + sizes)
    levels = [jax.tree.map(lambda a, o=o, n=n: a[o:o + n], flat) for o, n in zip(offs, sizes)]
    chunks = [scal[:, o:o + n] for o, n in zip(offs, sizes)]
    res = jmsm.msm_ragged(J, levels, chunks)
    pins["c_open"] = point_digest(J, jax.tree.map(lambda *a: jnp.stack(a), *res))
    assert pins == {k: cs.PINS[k] for k in pins}
