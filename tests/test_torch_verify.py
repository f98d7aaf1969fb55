"""Port parity: the collaborative verifier (``hyperplonk/verify.py``).

The JAX package makes the sim-mode bundles of its own tests (a
``dhyperplonk`` at (4, 1), tests/test_hyperplonk.py:163, and a
``dpermcheck`` at (5, 1), :337) from consistent shares and honest SRSs;
``convert`` carries bundle, SRSs and public tables into the port, whose
verifier must accept each honest bundle with its pairings and return the
JAX verifier's (ok, failures), letter for letter, on every corruption.
The verifier's helpers are held to the JAX package's on seeded transcripts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.curves import host_curve as jhc
from scalable_collaborative_zksnark_tpu.hyperplonk import collaborative as jcollab
from scalable_collaborative_zksnark_tpu.hyperplonk import params as jparams
from scalable_collaborative_zksnark_tpu.hyperplonk import verify as jverify
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu.primitives import poly_comm as jpc
from scalable_collaborative_zksnark_tpu.primitives import sumcheck as jsumcheck
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import verify
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.collaborative import eq_top_table
from scalable_collaborative_zksnark_tpu_torch.primitives import sumcheck
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams

C = 4  # the JAX package's MSM window in its CPU tests


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


def jax_honest_srs(J, n_vars: int, n_parties: int = 1, seed: int = 11):
    """The JAX package's test SRS (tests/test_hyperplonk.py:39-42)."""
    rng = np.random.RandomState(seed)
    s = [int.from_bytes(rng.bytes(40), "little") % J.fr.p for _ in range(n_vars)]
    return jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, s, n_parties=n_parties)


def _t(arr) -> torch.Tensor:
    return convert.from_numpy(np.asarray(arr), "cpu")


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------
def test_eval_mle_and_transcript_ints(curves):
    T, J = curves
    tbl, pt = J.fr.random((16,), 3), J.fr.random((4,), 4)
    assert verify.eval_mle_ints(T.fr, _t(tbl), _t(pt)) == jverify.eval_mle_ints(J.fr, tbl, pt)
    msgs = J.fr.random((5, 3), 5)
    assert verify.transcript_ints(T.fr, _t(msgs)) == jverify.transcript_ints(J.fr, msgs)
    rows = [[int(x) for x in r] for r in J.fr.array_to_ints(msgs)]
    for row, x in zip(rows, (0, 1, 2, 12345, T.fr.p - 1)):
        assert verify._eval_deg2(T.fr.p, row, x) == jverify._eval_deg2(J.fr.p, row, x)


def _transcript(T, J, d_form: bool):
    """A product transcript of seeded tables at a seeded point in both
    packages' forms: (port msgs, JAX msgs, challenge ints, f(r) g(r)).  The
    d-form drops the trailing (0, f(r) g(r), 0) row, as d_ transcripts do."""
    f, g, ch = J.fr.random((8,), 11), J.fr.random((8,), 12), J.fr.random((3,), 13)
    msgs = sumcheck.sumcheck_product(T.fr, _t(f), _t(g), _t(ch))
    np.testing.assert_array_equal(convert.to_numpy(msgs),
                                  np.asarray(jsumcheck.sumcheck_product(J.fr, f, g, ch)))
    if d_form:
        msgs = msgs[:-1]
    ch_ints = [int(x) for x in J.fr.array_to_ints(ch)]
    final = jverify.eval_mle_ints(J.fr, f, ch) * jverify.eval_mle_ints(J.fr, g, ch) % J.fr.p
    return msgs, np.asarray(convert.to_numpy(msgs)), ch_ints, final


@pytest.mark.parametrize("d_form", [False, True], ids=["final_row", "d_form"])
@pytest.mark.parametrize("case", ["honest", "wrong_final", "wrong_round"])
def test_check_product_transcript(curves, d_form, case):
    """``_check_product_transcript`` appends the JAX package's failures."""
    T, J = curves
    msgs, jmsgs, ch, final = _transcript(T, J, d_form)
    if case == "wrong_final":
        final += 1
    elif case == "wrong_round":
        msgs = msgs.clone()
        msgs[1, 1, 0] += 1
        jmsgs = jmsgs.copy()
        jmsgs[1, 1, 0] += 1
    got, want = [], []
    verify._check_product_transcript(T.fr, msgs, ch, final, got, "t", has_final_row=not d_form)
    jverify._check_product_transcript(J.fr, jmsgs, ch, final, want, "t",
                                      has_final_row=not d_form)
    assert got == want
    assert (not got) == (case == "honest")


# ---------------------------------------------------------------------------
# dhyperplonk, sim mode (4, 1)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sim_bundle(curves):
    """tests/test_hyperplonk.py:163's set-up in the JAX package, and its
    bundle, SRSs and public data carried into the port."""
    T, J = curves
    n, l = 4, 1
    N = 8 * l
    jnet = JaxNet(N, mode="sim")
    jpp = JaxPSS(J.fr, l)
    jd = jax_honest_srs(J, n + 2, n_parties=N, seed=31)
    jc = jax_honest_srs(J, n + 2, seed=37)
    jpk, jg = jparams.consistent_proving_parameters(
        n, l, jnet, srs={"c": jpc.srs_packed(jc, jpp), "d": jd}, curve=J)
    jproof = jcollab.dhyperplonk(n, jpk, jnet, c=C)
    eq_top = eq_top_table(T.fr, N)
    jeq_top = jnp.asarray(convert.to_numpy(eq_top))
    jax_side = (jpp, jc, jd, jproof, jg, jpk.challenge, jpk.challenge_r2, jeq_top)
    port = (PackedSharingParams(T.fr, l), convert.srs_from_numpy(T, jc),
            convert.srs_from_numpy(T, jd), convert.bundle_from_numpy(jproof, "cpu"),
            {k: _t(v) for k, v in jg.items()}, _t(jpk.challenge), _t(jpk.challenge_r2), eq_top)
    return jax_side, port


def test_verify_dhyperplonk_sim(sim_bundle):
    """The complete verifier, pairings included, accepts the JAX-made bundle."""
    _, port = sim_bundle
    assert verify.verify_dhyperplonk(*port) == (True, [])


def test_verify_dhyperplonk_gate_corrupted(sim_bundle):
    """tests/test_hyperplonk.py:248: one gate message changed."""
    (jpp, jc, jd, (jgate, _), jg, jch, _, _), (pp, c, d, _, g, ch, _, _) = sim_bundle
    bad = list(jgate[0])
    bad[1] = bad[1].at[:, 0, 1, 0].add(1)
    want = jverify.verify_dhyperplonk_gate(jpp, jc, jd, (bad, jgate[1]), jg["eq"], jch,
                                           pairings=False)
    got = verify.verify_dhyperplonk_gate(pp, c, d, convert.bundle_from_numpy(
        (bad, jgate[1]), "cpu"), g["eq"], ch, pairings=False)
    assert not want[0] and all("gate[1]" in f for f in want[1])
    assert got == want


def test_verify_dhyperplonk_wire_a_corrupted(sim_bundle):
    """tests/test_hyperplonk.py:262: one direct-zerocheck message changed."""
    (jpp, _, jd, (_, jwire), jg, _, jch2, _), (pp, _, d, _, g, _, ch2, _) = sim_bundle
    wp, wc, wo = jwire
    bad = list(wp)
    bad[2] = bad[2].at[0, 1, 0].add(1)
    want = jverify.verify_dhyperplonk_wire_a(jpp, jd, (bad, wc, wo), jg["eq_r2"], jch2,
                                             pairings=False)
    got = verify.verify_dhyperplonk_wire_a(pp, d, convert.bundle_from_numpy((bad, wc, wo), "cpu"),
                                           g["eq_r2"], ch2, pairings=False)
    assert not want[0] and any("zerocheck[1]" in f for f in want[1])
    assert got == want
