"""Port parity: the polynomial commitment, the non-dense MSM cores and the
masked point ops behind them.

Same seeded inputs through the JAX package and the port (plain versions on
the CPU, one intra-op thread).  The JAX package's ``add_mixed_masked`` and
``add_mixed_reset`` run their plain formulas on the CPU and are compared
bit for bit in Jacobian limbs; its MSMs run the native CPU kernels, which
return other Jacobian representatives, so commitments and proofs are
compared by affine value.  Field values and the party-net counters are
compared exactly.  Each test makes at most two MSM calls: the counters are
checked with the MSMs stubbed out, since they do not depend on MSM values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.curves import host_curve as jhc
from scalable_collaborative_zksnark_tpu.fields.config import int_to_limbs
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu.primitives import msm as jmsm
from scalable_collaborative_zksnark_tpu.primitives import poly_comm as jpc
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import msm
from scalable_collaborative_zksnark_tpu_torch.primitives import poly_comm as pc
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams


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


def _port(pt) -> PointJ:
    return convert.points_from_numpy([np.asarray(a) for a in pt], "cpu")


def _t(arr) -> torch.Tensor:
    return convert.from_numpy(np.asarray(arr), "cpu")


def _eq(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _eq_pts(got, want):
    for a, b in zip(convert.points_to_numpy(got), want, strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def _aff(T, J, got, want):
    assert T.to_affine_ints(got) == J.to_affine_ints(want)


def _counters(net):
    return net.up, net.down, net.rounds


@pytest.fixture(scope="module")
def srs_pair(curves):
    """The benchmark SRS of a 4-variable prove at l = 1 (8 parties) from
    both packages: "c" packed, "d" with root levels."""
    T, J = curves
    kw = {"c": dict(packed_parties=8, max_level=-1), "d": dict(n_parties=8, max_level=3)}
    return ({k: pc.srs_random(T, 4, 3, **v) for k, v in kw.items()},
            {k: jpc.srs_random(J, 4, 3, **v) for k, v in kw.items()})


@pytest.mark.parametrize("op", ["add_mixed_masked", "add_mixed_reset"])
def test_masked_group_law_bit_exact(curves, op):
    """Lanes: an equal pair (doubles), a cancelling pair, infinity on the
    right, infinity on the left, then random points; the mask is set on
    the special lanes and alternates on the rest."""
    T, J = curves
    h1 = [hc.g1_mul(hc.G1_GEN, 5 * i * i + i + 2) for i in range(1, 10)]
    h2 = [hc.g1_mul(hc.G1_GEN, 9 * i + 4) for i in range(1, 10)]
    h2[0], h2[1], h2[2], h1[3] = h1[0], hc.g1_neg(h1[1]), None, None
    p1 = J.double(J.from_affine_ints(h1))  # Z != 1
    a2 = J.from_affine_ints(h2)
    mask = np.array([1, 1, 1, 1, 0, 1, 0, 0, 1], dtype=bool)
    want = getattr(J, op)(p1, a2, jnp.asarray(mask))
    got = getattr(T, op)(_port(p1), _port(a2), torch.from_numpy(mask))
    _eq_pts(got, want)


def test_srs_random_levels(curves, srs_pair):
    """Every level of both SRS, normalized in both packages, bit for bit;
    the host G2 powers and party weights equal."""
    mine, theirs = srs_pair
    for k in ("c", "d"):
        a, b = mine[k], theirs[k]
        for name in ("powers_of_g", "root_levels", "packed_powers"):
            lv_a, lv_b = getattr(a, name) or [], getattr(b, name) or []
            assert len(lv_a) == len(lv_b), (k, name)
            for x, y in zip(lv_a, lv_b):
                _eq_pts(x, y)
        assert a.powers_of_g2 == b.powers_of_g2 and a.affine and b.affine
        assert (a.party_weights is None) == (b.party_weights is None)
    assert list(mine["d"].party_weights) == list(theirs["d"].party_weights)


def test_srs_constructors(curves):
    """srs_from_secret with the distributed extension (party weights and
    root levels by variable count), srs_ugly and srs_packed at l = 2 (two
    linear maps over G1) against the JAX package's, by affine value."""
    T, J = curves
    s = [12345, 67890]
    mine = pc.srs_from_secret(T, hc.G1_GEN, hc.G2_GEN, s, n_parties=2)
    theirs = jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, s, n_parties=2)
    assert mine.powers_of_g2 == theirs.powers_of_g2
    assert {k: list(v) for k, v in mine.party_weights.items()} == {
        k: list(v) for k, v in theirs.party_weights.items()}
    flat = lambda lv: lv if isinstance(lv, list) else [p for k in sorted(lv) for p in lv[k]]  # noqa: E731
    for name in ("powers_of_g", "root_levels"):
        got, want = flat(getattr(mine, name)), flat(getattr(theirs, name))
        assert [T.to_affine_ints(x) for x in got] == [J.to_affine_ints(y) for y in want]
    ugly, jugly = pc.srs_ugly(T, hc.G1_GEN, hc.G2_GEN, s, 2), jpc.srs_ugly(
        J, jhc.G1_GEN, jhc.G2_GEN, s, 2)
    assert [T.to_affine_ints(x) for x in ugly.powers_of_g] == [
        J.to_affine_ints(y) for y in jugly.powers_of_g]
    with pytest.raises(ValueError):
        pc.srs_ugly(T, hc.G1_GEN, hc.G2_GEN, s, 3)
    small = pc.PolynomialCommitment(T, mine.powers_of_g[:2], mine.powers_of_g2, affine=True)
    jsmall = jpc.PolynomialCommitment(J, theirs.powers_of_g[:2], theirs.powers_of_g2, affine=True)
    got = pc.srs_packed(small, PackedSharingParams(T.fr, 2)).packed_powers
    want = jpc.srs_packed(jsmall, JaxPSS(J.fr, 2)).packed_powers
    assert [T.to_affine_ints(x) for x in got] == [J.to_affine_ints(y) for y in want]
    assert got[0].x.shape[:-1] == (16, 1)


def _stub_msms(monkeypatch, T):
    """MSMs and ladders that return infinity of the right batch shape: the
    byte accounting around them does not depend on their values."""
    monkeypatch.setattr(pc, "msm", lambda curve, pts, s, c=8, affine=False: T.infinity(
        torch.broadcast_shapes(pts.x.shape[:-2], s.shape[:-2])))
    monkeypatch.setattr(pc, "msm_ragged", lambda curve, bases, scs, affine=False: [
        T.infinity(s.shape[:-2]) for s in scs])
    monkeypatch.setattr(pc, "_tiny_msm_rounds", lambda curve, bases, scs: [
        T.infinity(s.shape[:-2]) for s in scs])
    monkeypatch.setattr(T, "scalar_mul", lambda pt, s: T.infinity(
        torch.broadcast_shapes(pt.x.shape[:-1], s.shape[:-1])))


@pytest.mark.parametrize("mode", ["leader", "sim"])
def test_fold_and_comm_counters(curves, srs_pair, monkeypatch, mode):
    """``_fold_q`` and the opened values bit for bit, and every counter of
    d_commit, d_open, c_open and c_open_many, at l = 1 (8 parties)."""
    T, J = curves
    F, JF = T.fr, J.fr
    mine, theirs = srs_pair
    pp, jpp = PackedSharingParams(F, 1), JaxPSS(JF, 1)
    net, jnet = PartyNet(8, mode), JaxNet(8, mode)
    P = net.local_parties
    ev = np.asarray(JF.random((P, 2, 8), 51))
    pt = np.asarray(JF.random((6,), 52))
    qs, v = mine["d"]._fold_q(_t(ev), _t(pt), 3)
    jqs, jv = theirs["d"]._fold_q(jnp.asarray(ev), jnp.asarray(pt), 3)
    for a, b in zip(qs + [v], jqs + [jv], strict=True):
        _eq(a, b)

    _stub_msms(monkeypatch, T)
    mine["d"].d_commit(net, _t(ev))
    theirs["d"].d_commit(jnet, jnp.asarray(ev))
    assert _counters(net) == _counters(jnet)
    val, _ = mine["d"].d_open(net, _t(ev), _t(pt))
    jval, _ = theirs["d"].d_open(jnet, jnp.asarray(ev), jnp.asarray(pt))
    _eq(val, jval)
    assert _counters(net) == _counters(jnet)
    sh = np.asarray(JF.random((P, 8), 53))
    val, _ = pc.c_open(mine["c"], pp, net, _t(sh), _t(pt))
    jval, _ = jpc.c_open(theirs["c"], jpp, jnet, jnp.asarray(sh), jnp.asarray(pt))
    _eq(val, jval)
    items = [(sh, pt), (sh[:, ::-1].copy(), pt[::-1].copy())]
    got = pc.c_open_many(mine["c"], pp, net, [(_t(a), _t(b)) for a, b in items])
    want = jpc.c_open_many(theirs["c"], jpp, jnet, [(jnp.asarray(a), jnp.asarray(b))
                                                      for a, b in items])
    for (g, _), (w, _) in zip(got, want, strict=True):
        _eq(g, w)
    assert _counters(net) == _counters(jnet)


def test_c_commit_by_value(curves, srs_pair):
    """One c_commit of two share tables (8 and 4 per party), leader mode."""
    T, J = curves
    mine, theirs = srs_pair
    pp, jpp = PackedSharingParams(T.fr, 1), JaxPSS(J.fr, 1)
    net, jnet = PartyNet(8, "leader"), JaxNet(8, "leader")
    tabs = [np.asarray(J.fr.random((1, 8), 61)), np.asarray(J.fr.random((1, 4), 62))]
    got = pc.c_commit(mine["c"], pp, net, [_t(a) for a in tabs])
    want = jpc.c_commit(theirs["c"], jpp, jnet, [jnp.asarray(a) for a in tabs])
    _aff(T, J, got, want)
    assert _counters(net) == _counters(jnet)


def test_d_open_by_value(curves, srs_pair):
    """One d_open (two ragged MSMs: local rounds and root rounds)."""
    T, J = curves
    mine, theirs = srs_pair
    net, jnet = PartyNet(8, "leader"), JaxNet(8, "leader")
    ev = np.asarray(J.fr.random((1, 4), 71))
    pt = np.asarray(J.fr.random((5,), 72))
    val, pis = mine["d"].d_open(net, _t(ev), _t(pt))
    jval, jpis = theirs["d"].d_open(jnet, jnp.asarray(ev), jnp.asarray(pt))
    _eq(val, jval)
    assert len(pis) == len(jpis) == 5
    for a, b in zip(pis, jpis):
        _aff(T, J, a, b)


def test_c_open_many_by_value(curves, srs_pair):
    """c_open_many of two tables at l = 1 (one ragged d_msm, no phase 2)."""
    T, J = curves
    mine, theirs = srs_pair
    pp, jpp = PackedSharingParams(T.fr, 1), JaxPSS(J.fr, 1)
    net, jnet = PartyNet(8, "leader"), JaxNet(8, "leader")
    sh = np.asarray(J.fr.random((1, 4), 81))
    pts = [np.asarray(J.fr.random((2,), 82 + k)) for k in range(2)]
    got = pc.c_open_many(mine["c"], pp, net, [(_t(sh), _t(p)) for p in pts])
    want = jpc.c_open_many(theirs["c"], jpp, jnet, [(jnp.asarray(sh), jnp.asarray(p))
                                                      for p in pts])
    for (v, pr), (jv, jpr) in zip(got, want, strict=True):
        _eq(v, jv)
        _aff(T, J, pr, jpr)
    assert _counters(net) == _counters(jnet)


def test_verify_honest_open(curves):
    """commit, open and the host pairing check on an honest 2-variable SRS;
    a wrong value fails."""
    T, _ = curves
    F = T.fr
    rng = np.random.RandomState(7)
    s = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(2)]
    u = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(2)]
    ev = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(4)]
    srs = pc.srs_from_secret(T, hc.G1_GEN, hc.G2_GEN, s)
    assert srs.powers_of_g2[1] == jhc.g2_mul(jhc.G2_GEN, s[0])
    pe = F.array_from_ints(ev)
    com = srs.commit(pe)
    val, proofs = srs.open(pe, F.array_from_ints(u))
    v = int(F.array_to_ints(val))
    lo, hi = ev[:2], ev[2:]
    folded = [(a + u[0] * (b - a)) % hc.R for a, b in zip(lo, hi)]
    assert v == (folded[0] + u[1] * (folded[1] - folded[0])) % hc.R
    assert srs.verify(com, v, proofs, u)
    assert not srs.verify(com, (v + 1) % hc.R, proofs, u)


def _limbs(values):
    arr = np.asarray(values, dtype=object)
    return np.stack([int_to_limbs(int(v), 16) for v in arr.reshape(-1)]).reshape(arr.shape + (16,))


@pytest.fixture(scope="module")
def nondense_data(curves):
    T, J = curves
    rng = np.random.RandomState(17)
    host = [jhc.g1_mul(jhc.G1_GEN, int(k)) for k in rng.randint(1, 1 << 30, size=300)]
    host[4] = None
    host[9] = host[8]
    pts = J.double(J.from_affine_ints(host))
    sc = [int.from_bytes(rng.bytes(32), "little") % J.fr.p for _ in range(300)]
    sc[2] = 0
    return pts, _limbs(sc)


def test_non_dense_msm(curves, nondense_data, monkeypatch):
    """SCZK_MSM_DENSE=0: one 300-point msm through the bucket loop of
    ``add_mixed_masked`` (c = 8 as the caller's hint) equals the JAX
    package's MSM by value."""
    T, J = curves
    pts, sc = nondense_data
    monkeypatch.setenv("SCZK_MSM_DENSE", "0")
    assert not msm._dense_enabled()
    got = msm.msm(T, _port(pts), _t(sc))
    _aff(T, J, got, jmsm.msm(J, pts, jnp.asarray(sc)))


def test_non_dense_msm_ragged(curves, nondense_data, monkeypatch):
    """SCZK_MSM_DENSE=0: msm_ragged over 300 and 40 points in chunks of at
    most 128 (chunk partials summed per segment) equals the JAX package's
    MSMs by value; the chunk plan and window width are the JAX package's."""
    T, J = curves
    pts, sc = nondense_data
    sizes = (300, 40)
    assert msm._chunk_plan(sizes, 128) == jmsm._chunk_plan(sizes, 128) == (
        (128, 128, 44, 40), (0, 0, 0, 1))
    for n in (1, 511, 512, 8191, 8192):
        assert msm._pick_c(n) == jmsm._pick_c(n)
    monkeypatch.setenv("SCZK_MSM_DENSE", "0")
    bases = [jax.tree.map(lambda a, n=n: a[:n], pts) for n in sizes]
    got = msm.msm_ragged(T, [_port(b) for b in bases], [_t(sc[:n]) for n in sizes], chunk=128)
    for g, b, n in zip(got, bases, sizes):
        _aff(T, J, g, jmsm.msm(J, b, jnp.asarray(sc[:n])))
