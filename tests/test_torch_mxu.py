"""Port parity: the int8-matmul field engine and the sumcheck phases on it.

Same numpy-seeded inputs through the JAX package's ``fields/mxu.py`` and
``primitives/mxu_sumcheck.py`` (on the CPU) and the port's, which run
``torch._int_mm`` on the CPU.  The red8 coefficients and their bounds are
compared as exact integers, canonical limbs bit for bit; the phases also
against the port's default path, and the sumcheck variants and the merged
layered zerocheck with ``SCZK_MXU=1`` against the same JAX functions under
the same switch.
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu.fields import mxu as jmxu
from scalable_collaborative_zksnark_tpu.fields.fr import get_field as jax_field
from scalable_collaborative_zksnark_tpu.hyperplonk import collaborative as jcollab
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu.primitives import mxu_sumcheck as jmsc
from scalable_collaborative_zksnark_tpu.primitives import sumcheck as jsc
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import bench, convert
from scalable_collaborative_zksnark_tpu_torch.fields import mxu
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import packed_proving_parameters
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import cuda_sumcheck, mxu_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import sumcheck as sc
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams
from scalable_collaborative_zksnark_tpu_torch.utils.digest import proof_digest

FIELDS = ["bls12_381_fr", "bls12_381_fq"]
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engine runs many tiny tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def mxu_on(monkeypatch):
    """``SCZK_MXU=1`` for both packages (each reads it at call time)."""
    monkeypatch.setenv("SCZK_MXU", "1")


@functools.lru_cache(maxsize=None)
def _fields(name):
    return get_field(name, device="cpu"), jax_field(name)


def _rand(JF, shape, seed):
    return np.asarray(JF.random(shape, seed))


def _eq(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _same_red(got: mxu.Red, want):
    """Exact coefficients and the same static bound."""
    assert got.bound == want.bound
    np.testing.assert_array_equal(got.arr.numpy(), np.asarray(want.arr).astype(np.int64))


def _reds(arr, bound):
    """The same coefficients as a port Red and a JAX Red."""
    return mxu.Red(torch.from_numpy(arr), bound), jmxu.Red(arr.astype(np.uint32), bound)


def _edge(F, JF, n, seed):
    """n elements: 0, 1, p - 1 and R mod p first, then random ones."""
    x = _rand(JF, (n,), seed).copy()
    x[:4] = np.stack([JF.to_mont_int(v) for v in (0, 1, F.p - 1, F.spec.r % F.p)])
    return x


def _redundant(W, shape, bound, seed):
    """Random coefficients below ``bound``, the first row all at bound - 1."""
    arr = np.random.RandomState(seed).randint(0, bound, size=shape + (W,)).astype(np.int64)
    arr.reshape(-1, W)[0] = bound - 1
    return arr


@pytest.mark.parametrize("name", FIELDS)
def test_canon_and_linear_ops(name):
    """to_red, canon (of canonical values, and of redundant ones up to
    all-max coefficients at several bounds), add_red, sub_red (canonical
    and redundant operands) and sum_red against the JAX package."""
    F, JF = _fields(name)
    W = 2 * F.L
    x, y = _edge(F, JF, 9, 5), _rand(JF, (9,), 6)
    rx, ry = mxu.to_red(from_numpy(x)), mxu.to_red(from_numpy(y))
    jx, jy = jmxu.to_red(x), jmxu.to_red(y)
    _same_red(rx, jx)
    _eq(mxu.canon(F.spec, F, rx), x)
    rinv = pow(1 << (16 * F.L), F.p - 2, F.p)
    for bound in (256, 1 << 16, 1 << 24, (1 << 31) - 1):
        arr = _redundant(W, (5,), bound, bound % 97)
        red, jred = _reds(arr, bound)
        got = mxu.canon(F.spec, F, red)
        _eq(got, jmxu.canon(JF.spec, JF, jred))
        assert [int(v) for v in F.array_to_ints(got)] == [
            mxu.value_of(row) * rinv % F.p for row in arr]
    _same_red(mxu.add_red(rx, ry), jmxu.add_red(jx, jy))
    _same_red(mxu.sub_red(F.spec, rx, ry), jmxu.sub_red(JF.spec, jx, jy))
    _eq(mxu.canon(F.spec, F, mxu.sub_red(F.spec, rx, ry)), JF.sub(x, y))
    red, jred = _reds(_redundant(W, (9,), 1 << 24, 9), 1 << 24)
    _same_red(mxu.sub_red(F.spec, red, rx), jmxu.sub_red(JF.spec, jred, jx))
    # a redundant subtrahend at a power-of-two bound leaves D - b down to
    # -254: the minuend's coefficients (here >= 256) keep the result >= 0
    big = np.random.RandomState(10).randint(256, 1 << 24, size=(9, W)).astype(np.int64)
    big_t, big_j = _reds(big, 1 << 24)
    got = mxu.sub_red(F.spec, big_t, red)
    _same_red(got, jmxu.sub_red(JF.spec, big_j, jred))
    assert [int(v) for v in F.array_to_ints(mxu.canon(F.spec, F, got))] == [
        (mxu.value_of(u) - mxu.value_of(v)) * rinv % F.p for u, v in zip(big, red.arr)]
    for B in (3, 40):
        t = _rand(JF, (2, B), 20 + B)
        got = mxu.sum_red(F.spec, mxu.to_red(from_numpy(t)))
        _same_red(got, jmxu.sum_red(JF.spec, jmxu.to_red(t)))
        _eq(mxu.canon(F.spec, F, got), JF.sum(t, axis=-2))


@pytest.mark.parametrize("name", FIELDS)
def test_mul_shared_and_fold_matrix(name):
    """fold_matrix and mul_shared on canonical operands (with 0, 1, p - 1,
    R mod p) for the scalars 0, 1, p - 1 and a random one, and on a
    redundant operand; reduce_red of that product."""
    F, JF = _fields(name)
    x = _edge(F, JF, 12, 7)
    rx, jx = mxu.to_red(from_numpy(x)), jmxu.to_red(x)
    scalars = [JF.to_mont_int(v) for v in (0, 1, F.p - 1)] + [_rand(JF, (), 8)]
    for r in scalars:
        m_r, kmax = mxu.fold_matrix(F.spec, F, from_numpy(r), rx.bound, rx.W)
        jm_r, jkmax = jmxu.fold_matrix(JF.spec, JF, r, jx.bound, jx.W)
        assert kmax == jkmax
        np.testing.assert_array_equal(m_r.numpy(), np.asarray(jm_r).astype(np.int64))
        got = mxu.mul_shared(F.spec, rx, m_r)
        _same_red(got, jmxu.mul_shared(JF.spec, jx, jm_r))
        _eq(mxu.canon(F.spec, F, got), JF.mul(x, np.broadcast_to(r, x.shape)))
    red, jred = _reds(_redundant(2 * F.L, (6,), 1 << 24, 21), 1 << 24)
    m_r, _ = mxu.fold_matrix(F.spec, F, from_numpy(scalars[-1]), red.bound, red.W)
    jm_r, _ = jmxu.fold_matrix(JF.spec, JF, scalars[-1], jred.bound, jred.W)
    got, want = mxu.mul_shared(F.spec, red, m_r), jmxu.mul_shared(JF.spec, jred, jm_r)
    _same_red(got, want)
    _same_red(mxu.reduce_red(F.spec, got, 1), jmxu.reduce_red(JF.spec, want, 1))


@pytest.mark.parametrize("name", FIELDS)
def test_dot_red(name):
    """dot_red against the JAX package and against Field sums of products:
    edge values, a batched table and (Fr) redundant post-fold operands."""
    F, JF = _fields(name)
    cases = ((_edge(F, JF, 5, 31), _edge(F, JF, 5, 81)[::-1].copy()),
             (_rand(JF, (2, 3, 16), 32), _rand(JF, (2, 3, 16), 82)))
    for f, g in cases:
        got = mxu.dot_red(F.spec, mxu.to_red(from_numpy(f)), mxu.to_red(from_numpy(g)))
        _same_red(got, jmxu.dot_red(JF.spec, jmxu.to_red(f), jmxu.to_red(g)))
        _eq(mxu.canon(F.spec, F, got), JF.sum(JF.mul(f, g), axis=-2))
    if name != FIELDS[0]:
        return
    x, y, r = _rand(JF, (20,), 61), _rand(JF, (20,), 62), _rand(JF, (), 63)
    folded = []
    for v in (x, y):
        rv, jv = mxu.to_red(from_numpy(v)), jmxu.to_red(v)
        m_r, _ = mxu.fold_matrix(F.spec, F, from_numpy(r), rv.bound, rv.W)
        jm_r, _ = jmxu.fold_matrix(JF.spec, JF, r, jv.bound, jv.W)
        folded.append((mxu.mul_shared(F.spec, rv, m_r), jmxu.mul_shared(JF.spec, jv, jm_r)))
    (fx, jfx), (fy, jfy) = folded
    _same_red(mxu.dot_red(F.spec, fx, fy), jmxu.dot_red(JF.spec, jfx, jfy))


def test_large_batches_split():
    """dot_red and sum_red over MAX_CONTRACT + 3 elements run in two pieces
    whose results add, as in the JAX package."""
    F, JF = _fields(FIELDS[0])
    B = mxu.MAX_CONTRACT + 3
    f, g = _rand(JF, (B,), 41), _rand(JF, (B,), 42)
    rf, rg = mxu.to_red(from_numpy(f)), mxu.to_red(from_numpy(g))
    jf, jg = jmxu.to_red(f), jmxu.to_red(g)
    _same_red(mxu.dot_red(F.spec, rf, rg), jmxu.dot_red(JF.spec, jf, jg))
    _same_red(mxu.sum_red(F.spec, rf), jmxu.sum_red(JF.spec, jf))


def _jit(fn, *args):
    """A JAX package function under one jit: one compile instead of one per
    eager op and shape."""
    return jax.jit(fn)(*args)


@pytest.mark.parametrize("count", [None, 2])
def test_product_phase(count):
    """mxu_sumcheck.product_phase against the port's default round loop
    (the fold-phase plain version for a full fold, the unfused loop for a
    partial one) and, for the full fold, against the JAX package's."""
    F, JF = _fields(FIELDS[0])
    f, g, ch = _rand(JF, (2, 8), 71), _rand(JF, (2, 8), 72), _rand(JF, (6,), 73)
    got = mxu_sumcheck.product_phase(F, from_numpy(f), from_numpy(g), from_numpy(ch), 1, count)
    R = 3 if count is None else count
    default = sc._rounds_product(F, from_numpy(f), from_numpy(g), from_numpy(ch), 1, R)
    assert len(got[0]) == len(default[0]) == R
    for a, c in zip(got[0] + [got[1], got[2]], default[0] + [default[1], default[2]]):
        assert torch.equal(a, c)
    if count is None:
        jm, jf, jg = _jit(lambda *a: jmsc.product_phase(JF, *a, 1), f, g, ch)
        for a, b in zip(got[0] + [got[1], got[2]], list(jm) + [jf, jg]):
            _eq(a, b)


def test_single_phase():
    """mxu_sumcheck.single_phase against the JAX package's and the port's
    default round loop."""
    F, JF = _fields(FIELDS[0])
    f, ch = _rand(JF, (2, 8), 91), _rand(JF, (6,), 93)
    got = mxu_sumcheck.single_phase(F, from_numpy(f), from_numpy(ch), 2)
    jm, jc = _jit(lambda *a: jmsc.single_phase(JF, *a, 2), f, ch)
    default = sc._rounds_single(F, from_numpy(f), from_numpy(ch), 2, 3)
    for a, b, c in zip(got[0] + [got[1]], list(jm) + [jc], default[0] + [default[1]]):
        _eq(a, b)
        assert torch.equal(a, c)


def test_available_reads_the_switch(monkeypatch):
    monkeypatch.delenv("SCZK_MXU", raising=False)
    assert not mxu_sumcheck.available()
    monkeypatch.setenv("SCZK_MXU", "0")
    assert not mxu_sumcheck.available()
    monkeypatch.setenv("SCZK_MXU", "1")
    assert mxu_sumcheck.available()


def _counters(net):
    return net.up, net.down, net.rounds


VARIANTS = ["c_sumcheck_product", "d_sumcheck_product", "c_sumcheck"]


def _variant(fn, F, f, g, ch, net_cls, pss):
    """(transcript, net) of one leader-mode variant call at l = 2 (N = 16)
    on [1, 16] tables, in either package."""
    net = net_cls(16, "leader")
    if fn == "d_sumcheck_product":
        return F, net, lambda mod, *a: mod.d_sumcheck_product(F, net, *a), (f, g, ch)
    pp = pss(F, 2)
    if fn == "c_sumcheck":
        return F, net, lambda mod, *a: mod.c_sumcheck(pp, net, *a), (f, ch)
    return F, net, lambda mod, *a: mod.c_sumcheck_product(pp, net, *a), (f, g, ch)


def _variant_inputs():
    JF = _fields(FIELDS[0])[1]
    return _rand(JF, (1, 16), 61), _rand(JF, (1, 16), 62), _rand(JF, (10,), 63)


@pytest.mark.parametrize("fn", VARIANTS)
def test_variants_under_the_switch(fn, monkeypatch):
    """With ``SCZK_MXU=1`` the collaborative and distributed variants (leader
    mode, l = 2) give the port's default transcript and counters (which
    the sumcheck tests hold to the JAX package's)."""
    F = _fields(FIELDS[0])[0]
    args = tuple(from_numpy(x) for x in _variant_inputs())
    _, dnet, call, a = _variant(fn, F, *args, PartyNet, PackedSharingParams)
    default = call(sc, *a)
    monkeypatch.setenv("SCZK_MXU", "1")
    _, net, call, a = _variant(fn, F, *args, PartyNet, PackedSharingParams)
    assert torch.equal(call(sc, *a), default)
    assert _counters(net) == _counters(dnet)


@pytest.mark.slow
@pytest.mark.parametrize("fn", VARIANTS)
def test_variants_match_jax_under_the_switch(fn, mxu_on):
    """The same calls against the JAX package's under ``SCZK_MXU=1`` (its
    int8 phases, compiled for the CPU)."""
    F, JF = _fields(FIELDS[0])
    raw = _variant_inputs()
    _, net, call, a = _variant(fn, F, *map(from_numpy, raw), PartyNet, PackedSharingParams)
    _, jnet, jcall, ja = _variant(fn, JF, *raw, JaxNet, JaxPSS)
    _eq(call(sc, *a), _jit(lambda *x: jcall(jsc, *x), *ja))
    assert _counters(net) == _counters(jnet)


def _wire_b(F, net, tables):
    return collaborative._wire_b_sumchecks(SimpleNamespace(pp=SimpleNamespace(field=F)), net,
                                           *tables)


def _wire_b_inputs():
    """A 32-row subtree's views, eq table and challenges at N = 8: three
    layers."""
    JF = _fields(FIELDS[0])[1]
    return [_rand(JF, (1, 32), 90 + k) for k in range(4)] + [_rand(JF, (10,), 95)]


def test_wire_b_sumchecks_under_the_switch(monkeypatch):
    """The merged layered-zerocheck rounds with ``SCZK_MXU=1`` (one canon
    over every message and both finals) against the port's default branch,
    which the hyperplonk tests hold to the JAX package's."""
    F = _fields(FIELDS[0])[0]
    tables = [from_numpy(x) for x in _wire_b_inputs()]
    dnet, net = PartyNet(8, "leader"), PartyNet(8, "leader")
    default = _wire_b(F, dnet, tables)
    monkeypatch.setenv("SCZK_MXU", "1")
    got = _wire_b(F, net, tables)
    assert len(got) == len(default) == 3
    for a, c in zip(got, default):
        assert torch.equal(a, c)
    assert _counters(net) == _counters(dnet)


@pytest.mark.slow
def test_wire_b_sumchecks_match_jax_under_the_switch(mxu_on):
    """The same merged rounds against the JAX package's MXU branch."""
    F, JF = _fields(FIELDS[0])
    raw = _wire_b_inputs()
    net, jnet = PartyNet(8, "leader"), JaxNet(8, "leader")
    got = _wire_b(F, net, [from_numpy(x) for x in raw])
    want = jcollab._wire_b_sumchecks(SimpleNamespace(pp=SimpleNamespace(field=JF)), jnet, *raw)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _eq(a, b)
    assert _counters(net) == _counters(jnet)


@pytest.mark.slow
def test_prove_digest_n6_l1_under_the_switch(mxu_on):
    """The (6, 1) leader-mode prove with ``SCZK_MXU=1`` proves the JAX
    package's pin (about 2 min on the CPU)."""
    net = PartyNet(8, "leader")
    pk = packed_proving_parameters(6, 1, net, device="cpu")
    mxu.matmuls = 0
    out = collaborative.dhyperplonk(6, pk, net)
    assert mxu.matmuls > 0
    assert proof_digest(pk.curve, out) == bench.PINS[(6, 1)]
