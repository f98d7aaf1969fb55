"""Port parity: the prover's inputs, its gate-identity step and the merged
layered-zerocheck graph; and (marked slow) the recomputation of
chip_smoke.py's prove pins from the JAX package.

Same seeded inputs through the JAX package and the port (plain versions on
the CPU, one intra-op thread).  Field tables are compared bit for bit; the
SRS points, normalized in both packages, bit for bit too.  None of these
tests but the slow one makes an MSM call.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.hyperplonk import collaborative as jcollab
from scalable_collaborative_zksnark_tpu.hyperplonk import params as jparams
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu_torch import bench, convert
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative, params
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import sumcheck

N, L = 6, 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions run many tiny tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pks():
    """The (6, 1) leader-mode inputs of both packages, each made by its own
    ``packed_proving_parameters``."""
    T, J = bls12_381_g1("cpu"), jg1.bls12_381_g1()
    pk = params.packed_proving_parameters(N, L, PartyNet(8 * L, "leader"), curve=T)
    jpk = jparams.packed_proving_parameters(N, L, JaxNet(8 * L, "leader"), curve=J)
    return pk, jpk


def _eq(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def _eq_levels(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _eq_levels(got[k], want[k])
        return
    assert (got is None) == (want is None)
    for g, w in zip(got or [], want or [], strict=True):
        for a, b in zip(convert.points_to_numpy(g), w, strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_packed_proving_parameters(pks):
    """Every field of the (6, 1) inputs equals the JAX package's: tables
    and challenges bit for bit, the SRS levels (normalized) bit for bit,
    the host G2 powers and party weights as values."""
    pk, jpk = pks
    for f in dataclasses.fields(params.PackedProvingParameters):
        got, want = getattr(pk, f.name), getattr(jpk, f.name)
        if f.name == "n":
            assert got == want
        elif f.name == "pp":
            assert (got.l, got.n) == (want.l, want.n)
        elif f.name == "curve":
            assert got.name == want.name
        elif f.name.endswith("_commitment"):
            for lv in ("powers_of_g", "root_levels", "packed_powers"):
                _eq_levels(getattr(got, lv), getattr(want, lv))
            assert got.powers_of_g2 == want.powers_of_g2 and got.affine == want.affine
            weights = lambda w: None if w is None else [int(x) for x in w]  # noqa: E731
            assert weights(got.party_weights) == weights(want.party_weights)
        else:
            _eq(got, want)


def test_proving_parameters_from_numpy(pks):
    """The JAX package's inputs carried into the port equal the port's own."""
    pk, jpk = pks
    carried = convert.proving_parameters_from_numpy(jpk, "cpu")
    for f in dataclasses.fields(params.PackedProvingParameters):
        a, b = getattr(carried, f.name), getattr(pk, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    for lv in ("powers_of_g", "packed_powers"):
        for x, y in zip(getattr(carried.c_commitment, lv) or [], getattr(pk.c_commitment, lv) or []):
            assert all(torch.equal(u, v) for u, v in zip(x, y))


def test_gate_identity_bit_exact(pks):
    """The six gate-identity sumchecks (one batched c_sumcheck_product) and
    their counters, on the JAX package's inputs carried across."""
    _, jpk = pks
    pk = convert.proving_parameters_from_numpy(jpk, "cpu")
    net, jnet = PartyNet(8 * L, "leader"), JaxNet(8 * L, "leader")
    got = collaborative._gate_identity(pk, net)
    want = jcollab._gate_identity(jpk, jnet)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _eq(g, w)
    assert (net.up, net.down, net.rounds) == (jnet.up, jnet.down, jnet.rounds)


def test_consistent_proving_parameters():
    """The sim-mode consistent inputs at (4, 1) (SRS passed through)."""
    T, J = bls12_381_g1("cpu"), jg1.bls12_381_g1()
    srs = {"c": None, "d": None}
    pk, g = params.consistent_proving_parameters(4, 1, PartyNet(8, "sim"), srs, curve=T)
    jpk, jg = jparams.consistent_proving_parameters(4, 1, JaxNet(8, "sim"), srs, curve=J)
    for f in dataclasses.fields(params.PackedProvingParameters):
        if isinstance(getattr(pk, f.name), torch.Tensor):
            _eq(getattr(pk, f.name), getattr(jpk, f.name))
    assert set(g) == set(jg)
    for k in g:
        _eq(g[k], jg[k])
    with pytest.raises(ValueError):
        params.consistent_proving_parameters(4, 1, PartyNet(8, "leader"), srs, curve=T)


def test_merged_layer_sumchecks_equal_per_layer(pks):
    """``_wire_b_sumchecks`` (all layers' rounds merged) against one
    ``d_sumcheck_product`` per layer on the halving slices, and the bytes
    of both against the JAX package's merged graph, at (6, 1): three
    layers."""
    pk, jpk = pks
    F = pk.pp.field
    rnd = lambda k: F.random((1, 32), 90 + k)  # noqa: E731 (a 64-node subtree's views)
    v1x, vx0, vx1 = rnd(0), rnd(1), rnd(2)
    net, jnet, lnet = PartyNet(8, "leader"), JaxNet(8, "leader"), PartyNet(8, "leader")
    merged = collaborative._wire_b_sumchecks(pk, net, v1x, vx0, vx1, pk.eq_r2_p, pk.challenge_r2)
    want = jcollab._wire_b_sumchecks(jpk, jnet, *(np.asarray(convert.to_numpy(t))
                                                  for t in (v1x, vx0, vx1)),
                                     jpk.eq_r2_p, jpk.challenge_r2)
    assert len(merged) == len(want) == N - 3
    half = 16
    cur = [v1x[..., :half, :], vx0[..., :half, :], vx1[..., :half, :],
           pk.eq_r2_p[..., : pk.eq_r2_p.shape[-2] // 2, :]]
    for i, (m, w) in enumerate(zip(merged, want), start=1):
        _eq(m, w)
        layer = sumcheck.d_sumcheck_product(
            F, lnet, collaborative._stackp([cur[3], cur[3], cur[1]]),
            collaborative._stackp(cur[:3]), collaborative._dsum_ch(lnet, pk.challenge_r2[i:]))
        assert torch.equal(m, layer), i
        cur = [t[..., t.shape[-2] // 2:, :] for t in cur]
    assert (net.up, net.down, net.rounds) == (jnet.up, jnet.down, jnet.rounds) == (
        lnet.up, lnet.down, lnet.rounds)


def _jax_prove_pins(n, l):
    """The JAX package's leader-mode prove: (canonical digest, comm)."""
    from scalable_collaborative_zksnark_tpu.utils.benchlib import proof_digest

    jnet = JaxNet(8 * l, "leader")
    jpk = jparams.packed_proving_parameters(n, l, jnet)
    jnet.reset_comm()
    out = jcollab.dhyperplonk(n, jpk, jnet)
    return proof_digest(out), chip_smoke._comm(jnet)


@pytest.mark.slow
def test_chip_smoke_prove_pins():
    """Recompute chip_smoke.py's prove pins from the JAX package on the CPU
    (dhyperplonk in leader mode at (16, 8) and (6, 1)): the digests equal
    bench.py's CONFORMANCE_PIN and the port bench's copy, and the (16, 8)
    comm of one prove equals the pin."""
    import bench as jax_bench

    for (n, l), key in (((16, 8), "prove_n16_l8"), ((6, 1), "prove_n6_l1")):
        digest, comm = _jax_prove_pins(n, l)
        assert digest == chip_smoke.PINS[key] == jax_bench.CONFORMANCE_PIN[(n, l)] == bench.PINS[
            (n, l)]
        if (n, l) == (16, 8):
            assert comm == chip_smoke.PINS["prove_n16_l8_comm"]
