"""Port parity: the honest SRS built on the device, the PSS G2 methods and
the host pairing's final exponentiation.

``srs_from_secret`` builds each level's scalars as Fr tensor products and
every point as one ladder from the generator; with ``pp`` it packs the
c-SRS from the same scalars.  On the CPU the same code runs through the
plain versions, and the points must equal the JAX package's host build by
affine value.
"""

import random

import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.curves import host_curve as jhc
from scalable_collaborative_zksnark_tpu.fields.fr import get_field as jax_field
from scalable_collaborative_zksnark_tpu.primitives import poly_comm as jpc
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
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
def srs_pairs():
    """6-variable SRSs from one seeded secret in both packages: plain, with
    8 parties' weights and root levels, and packed for l = 1 (8 parties)."""
    T, J = bls12_381_g1("cpu"), jg1.bls12_381_g1()
    rng = np.random.RandomState(17)
    s = [int.from_bytes(rng.bytes(40), "little") % T.fr.p for _ in range(6)]
    mine = pc.srs_from_secret(T, hc.G1_GEN, hc.G2_GEN, s, n_parties=8)
    theirs = jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, s, n_parties=8)
    packed = pc.srs_from_secret(T, hc.G1_GEN, hc.G2_GEN, s, pp=PackedSharingParams(T.fr, 1))
    jpacked = jpc.srs_packed(jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, s),
                             JaxPSS(J.fr, 1))
    return T, J, mine, theirs, packed, jpacked


def _affine(curve, levels):
    return [curve.to_affine_ints(lv) for lv in levels]


def test_srs_from_secret_levels(srs_pairs):
    """Every level equal by affine value, stored normalized (z in {0, 1})."""
    T, J, mine, theirs, _, _ = srs_pairs
    assert _affine(T, mine.powers_of_g) == _affine(J, theirs.powers_of_g)
    assert [lv.x.shape[0] for lv in mine.powers_of_g] == [1 << k for k in range(7)]
    assert mine.affine and all(bool(((lv.z == 0) | (lv.z == T.fq.const(1))).all())
                               for lv in mine.powers_of_g)
    assert mine.powers_of_g2 == theirs.powers_of_g2


def test_srs_from_secret_distributed_extension(srs_pairs):
    """The party weights (host ints) and root levels, keyed by m_total."""
    T, J, mine, theirs, _, _ = srs_pairs
    assert sorted(mine.party_weights) == sorted(theirs.party_weights) == [3, 4, 5, 6]
    for k in theirs.party_weights:
        assert list(mine.party_weights[k]) == list(theirs.party_weights[k])
        assert _affine(T, mine.root_levels[k]) == _affine(J, theirs.root_levels[k])


def test_srs_packed_from_scalars(srs_pairs):
    """The packed c-SRS from the level scalars, one ladder a (chunk, party),
    against the JAX package's group map over the points, with levels
    shorter than l padded."""
    T, J, _, _, packed, jpacked = srs_pairs
    assert [tuple(lv.x.shape[:-1]) for lv in packed.packed_powers] == [
        (8, 1 << k) for k in range(7)]
    assert _affine(T, packed.packed_powers) == _affine(J, jpacked.packed_powers)


def test_srs_packed_pads_short_levels():
    """At l = 2 the 1-point level 0 is padded with the scalar 0 (infinity)."""
    T, J = bls12_381_g1("cpu"), jg1.bls12_381_g1()
    s = [12345, 67890]
    got = pc.srs_from_secret(T, hc.G1_GEN, hc.G2_GEN, s,
                             pp=PackedSharingParams(T.fr, 2)).packed_powers
    want = jpc.srs_packed(jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, s),
                          JaxPSS(J.fr, 2)).packed_powers
    assert [tuple(lv.x.shape[:-1]) for lv in got] == [(16, 1), (16, 1), (16, 2)]
    assert _affine(T, got) == _affine(J, want)


@pytest.mark.parametrize("method", ["pack_from_public_g2", "unpack_g2", "unpack2_g2"])
def test_pss_g2_methods(method):
    """The G2 methods against the JAX package's (tests/test_pss.py:106), on
    seeded G2 points (l = 2)."""
    pp, jpp = PackedSharingParams(get_field("bls12_381_fr", "cpu"), 2), JaxPSS(
        jax_field("bls12_381_fr"), 2)
    rng = np.random.RandomState(51)
    size = pp.l if method == "pack_from_public_g2" else pp.n
    ks = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(size)]
    pts = [hc.g2_mul(hc.G2_GEN, k) for k in ks]
    assert getattr(pp, method)(pts) == getattr(jpp, method)(pts)


def test_pss_g2_roundtrip():
    pp = PackedSharingParams(get_field("bls12_381_fr", "cpu"), 2)
    pts = [hc.g2_mul(hc.G2_GEN, k) for k in (5, 7)]
    shares = pp.pack_from_public_g2(pts)
    assert len(shares) == 16 and pp.unpack_g2(shares) == pts
    assert pp.unpack2_g2([hc.g2_add(x, x) for x in shares]) == [hc.g2_mul(q, 2) for q in pts]


def test_final_exponentiation():
    """The split final exponentiation equals one pow to (q^12 - 1) / r on
    seeded Fq12 elements, and the pairing equals the JAX package's oracle."""
    rnd = random.Random(3)
    for _ in range(2):
        f = tuple(tuple((rnd.randrange(hc.P), rnd.randrange(hc.P)) for _ in range(3))
                  for _ in range(2))
        assert hc.final_exponentiation(f) == hc.f12_pow(f, (hc.P**12 - 1) // hc.R)
    p1, q1 = hc.g1_mul(hc.G1_GEN, 3), hc.g2_mul(hc.G2_GEN, 7)
    assert hc.pairing(p1, q1) == jhc.pairing(p1, q1)
    assert hc.pairing_product_is_one([(p1, q1), (hc.g1_neg(hc.g1_mul(hc.G1_GEN, 21)),
                                                 hc.G2_GEN)])
