"""Port parity: the MLE helpers, degree reduction and the product tree.

Same seeded inputs through the JAX package and the port (plain versions
on the CPU, one intra-op thread): limb arrays bit for bit, the party-net
byte and round counters exactly.  No MSM is involved.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu.fields.fr import get_field as jax_field
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu.primitives import acc_product as jacc
from scalable_collaborative_zksnark_tpu.primitives import degree_reduce as jdr
from scalable_collaborative_zksnark_tpu.primitives import mle as jmle
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import acc_product, degree_reduce, mle
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams

NAME = "bls12_381_fr"
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions run many tiny tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fields():
    return get_field(NAME, device="cpu"), jax_field(NAME)


def _eq(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _nets(n, mode):
    return PartyNet(n, mode), JaxNet(n, mode)


def _counters(net):
    return net.up, net.down, net.rounds


def test_sub_index_and_local_tree(fields):
    F, JF = fields
    assert acc_product.sub_index(26) == jacc.sub_index(26) == (20, 21)
    x = np.asarray(JF.random((2, 64), 3))  # n = 6
    for got, want in zip(acc_product.acc_product(F, from_numpy(x)), jacc.acc_product(JF, x)):
        _eq(got, want)
    assert [int(v) for v in F.array_to_ints(acc_product.acc_product(
        F, F.array_from_ints([1, 2, 3, 4]))[2])] == [2, 12, 24, 0]


@pytest.mark.parametrize("mode", ["leader", "sim"])
def test_d_acc_product(fields, mode):
    F, JF = fields
    net, jnet = _nets(8, mode)
    x = np.asarray(JF.random((net.local_parties, 8), 5))  # 2^6 values over 8 parties
    got = acc_product.d_acc_product(F, net, from_numpy(x))
    want = jacc.d_acc_product(JF, jnet, x)
    for g, w in zip(got, want):
        _eq(g, w)
    assert _counters(net) == _counters(jnet)


@pytest.mark.parametrize("mode", ["leader", "sim"])
def test_c_acc_product_and_share(fields, mode):
    """The full collaborative pipeline at l = 2 (16 parties), 128 shares per
    party: mask, unpack2 all-to-all, trees, re-sharing, unmask and the
    sampled degree reduction (its bytes)."""
    F, JF = fields
    l, S = 2, 128
    pp, jpp = PackedSharingParams(F, l), JaxPSS(JF, l)
    net, jnet = _nets(pp.n, mode)
    P = net.local_parties
    args = [np.asarray(JF.random((P, S), 11 + k)) for k in range(5)]
    got = acc_product.c_acc_product_and_share(pp, net, *map(from_numpy, args))
    want = jacc.c_acc_product_and_share(jpp, jnet, *args)
    for g, w in zip(got, want, strict=True):
        _eq(g, w)
    assert _counters(net) == _counters(jnet)


def test_fix_variable_and_pack(fields):
    F, JF = fields
    pp, jpp = PackedSharingParams(F, 2), JaxPSS(JF, 2)
    ev = np.asarray(JF.random((3, 64), 21))
    pts = np.asarray(JF.random((4,), 22))
    _eq(mle.fix_variable(F, from_numpy(ev), from_numpy(pts)), jmle.fix_variable(JF, ev, pts))
    shares = mle.pack_vec(pp, from_numpy(ev))
    _eq(shares, jmle.pack_vec(jpp, ev))
    _eq(mle.unpack_vec(pp, shares), ev)
    sq = np.asarray(JF.mul(jmle.pack_vec(jpp, ev), jmle.pack_vec(jpp, ev)))
    _eq(mle.unpack2_vec(pp, from_numpy(sq)), jmle.unpack2_vec(jpp, sq))
    with pytest.raises(ValueError):
        mle.pack_vec(pp, from_numpy(ev[:, :3]))


@pytest.mark.parametrize("k", [3, 6])
def test_d_fix_variable(fields, k):
    """k <= n stays local; k > n crosses pss2ss (phase 2 at points[n:])."""
    F, JF = fields
    pp, jpp = PackedSharingParams(F, 2), JaxPSS(JF, 2)
    net, jnet = _nets(pp.n, "sim")
    shares = np.asarray(JF.random((pp.n, 16), 31))  # n = 4 local variables
    pts = np.asarray(JF.random((k,), 32))
    _eq(mle.d_fix_variable(pp, net, from_numpy(shares), from_numpy(pts)),
        jmle.d_fix_variable(jpp, jnet, jnp.asarray(shares), pts))
    assert _counters(net) == _counters(jnet)


@pytest.mark.parametrize("mode", ["leader", "sim"])
def test_degree_reduce(fields, mode):
    F, JF = fields
    pp, jpp = PackedSharingParams(F, 2), JaxPSS(JF, 2)
    net, jnet = _nets(pp.n, mode)
    P = net.local_parties
    one = np.asarray(JF.random((P,), 41))
    many = np.asarray(JF.random((P, 5), 42))
    _eq(degree_reduce.degree_reduce(pp, net, from_numpy(one)), jdr.degree_reduce(jpp, jnet, one))
    _eq(degree_reduce.degree_reduce_many(pp, net, from_numpy(many)),
        jdr.degree_reduce_many(jpp, jnet, many))
    assert _counters(net) == _counters(jnet)
