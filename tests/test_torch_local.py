"""Port parity: the local HyperPlonk provers, their inputs, the local
verifier, and the hyperplonk example on the CPU.

Same seeded inputs through the JAX package and the port (plain versions on
the CPU, one intra-op thread).  Inputs are compared bit for bit, bundles by
canonical digest (points by affine value: the JAX package's CPU MSMs return
other Jacobian representatives), verifier results as (ok, failures).  The
JAX package's bundles and SRSs are carried across with ``convert``.
"""

import re

import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.curves import host_curve as jhc
from scalable_collaborative_zksnark_tpu.hyperplonk import local as jlocal
from scalable_collaborative_zksnark_tpu.hyperplonk import verify as jverify
from scalable_collaborative_zksnark_tpu.primitives import poly_comm as jpc
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.examples import hyperplonk as hp_example
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import local, verify
from scalable_collaborative_zksnark_tpu_torch.utils.digest import proof_digest

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


def jax_honest_srs(J, n_vars: int, seed: int):
    """The JAX package's test SRS (tests/test_hyperplonk.py:39-42)."""
    rng = np.random.RandomState(seed)
    s = [int.from_bytes(rng.bytes(40), "little") % J.fr.p for _ in range(n_vars)]
    return jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, s)


@pytest.mark.parametrize("n,seed", [(2, 0), (3, 5)])
def test_local_inputs_bit_exact(curves, n, seed):
    T, J = curves
    got = local.local_inputs(T.fr, n, seed)
    want = jlocal.local_inputs(J.fr, n, seed)
    carried = convert.local_inputs_from_numpy(want, "cpu")
    assert got.n == want.n == carried.n == n
    for name in ("m", "a", "b", "c", "input", "q1", "q2", "ssigma", "sid", "eq", "eq_p2",
                 "challenge", "challengep2", "challengep2_2", "alpha", "beta"):
        np.testing.assert_array_equal(convert.to_numpy(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
        assert torch.equal(getattr(carried, name), getattr(got, name)), name


def test_local_hyperplonk_equals_jax(curves):
    """local_hyperplonk at n = 2 (c = 4) on the JAX package's honest SRS:
    the reference's element counts and the JAX package's values."""
    T, J = curves
    n = 2
    jsrs = jax_honest_srs(J, n + 2, 11)
    srs = convert.srs_from_numpy(T, jsrs)
    got = local.local_hyperplonk(n, srs, c=C)
    want = jlocal.local_hyperplonk(n, jsrs, c=C)
    (gp, gc), (wp, wc, wo) = got
    assert (len(gp), len(gc), len(wp), len(wc), len(wo)) == (6, 6, 6, 8, 8)
    assert gp[0].shape == (n + 1, 3, T.fr.L) and wp[0].shape == (n + 3, 3, T.fr.L)
    assert proof_digest(T, got) == proof_digest(T, convert.bundle_from_numpy(want, "cpu"))


@pytest.fixture(scope="module")
def local_bundle(curves):
    """The JAX package's n = 3 bundle of tests/test_hyperplonk.py:317, with
    its SRS and inputs, and the same carried into the port."""
    T, J = curves
    n = 3
    jsrs = jax_honest_srs(J, n + 2, 23)
    jins = jlocal.local_inputs(J.fr, n, seed=5)
    jproof = jlocal.local_hyperplonk(n, jsrs, jins, c=C)
    return (n, jsrs, jins, jproof, convert.srs_from_numpy(T, jsrs),
            convert.local_inputs_from_numpy(jins, "cpu"))


def test_verify_local_hyperplonk_honest(local_bundle):
    n, _, _, jproof, srs, ins = local_bundle
    assert verify.verify_local_hyperplonk(n, srs, convert.bundle_from_numpy(jproof, "cpu"),
                                          ins) == (True, [])


def _gate_transcript(J, jproof):
    (gp, gc), wire = jproof
    bad = list(gp)
    bad[3] = bad[3].at[1, 1, 0].add(1)
    return ((bad, gc), wire), False


def _opened_value(J, jproof):
    (gp, gc), wire = jproof
    com, (val, pis) = gc[0]
    bad = list(gc)
    bad[0] = (com, (J.fr.add(val, J.fr.const(1)), pis))
    return ((gp, bad), wire), True


def _swapped_commitments(J, jproof):
    (gp, gc), (wp, wc, wo) = jproof
    bad = list(wc)
    bad[2], bad[3] = bad[3], bad[2]
    return ((gp, gc), (wp, bad, wo)), True


@pytest.mark.parametrize("corrupt", [_gate_transcript, _opened_value, _swapped_commitments],
                         ids=["gate_transcript", "opened_value", "swapped_commitments"])
def test_verify_local_hyperplonk_corrupted(curves, local_bundle, corrupt):
    """The three corruptions of tests/test_hyperplonk.py:317-334: the port's
    verifier returns the JAX verifier's failures, letter for letter."""
    _, J = curves
    n, jsrs, jins, jproof, srs, ins = local_bundle
    bad, pairings = corrupt(J, jproof)
    want = jverify.verify_local_hyperplonk(n, jsrs, bad, jins, pairings=pairings)
    got = verify.verify_local_hyperplonk(n, srs, convert.bundle_from_numpy(bad, "cpu"), ins,
                                         pairings=pairings)
    assert not want[0] and want[1]
    assert got == want


def test_hyperplonk_example_local_line(capsys):
    """``examples.hyperplonk --variant local`` prints the JAX example's line."""
    hp_example.main(["--variant", "local", "--n", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"local hyperplonk n=2: \d+\.\d{3} s", out[-1]), out
