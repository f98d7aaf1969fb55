"""Port parity: the collaborative verifier's wire section on a
``dpermcheck`` bundle.

The JAX package proves ``dpermcheck`` at (5, 1) in sim mode from
consistent shares and an honest d-SRS (tests/test_hyperplonk.py:337: part
a, a two-layer layered zerocheck and the tree top); ``convert`` carries the
bundle into the port, whose ``verify_dhyperplonk_wire`` must accept it with
its pairings and return the JAX verifier's (ok, failures), letter for
letter, on its three corruptions (:372-394).
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
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import verify
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.collaborative import eq_top_table
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams

C = 4  # the JAX package's MSM window in its CPU tests


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions run many tiny tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_honest_srs(J, n_vars: int, n_parties: int = 1, seed: int = 11):
    """The JAX package's test SRS (tests/test_hyperplonk.py:39-42)."""
    rng = np.random.RandomState(seed)
    s = [int.from_bytes(rng.bytes(40), "little") % J.fr.p for _ in range(n_vars)]
    return jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, s, n_parties=n_parties)


def _t(arr) -> torch.Tensor:
    return convert.from_numpy(np.asarray(arr), "cpu")


@pytest.fixture(scope="module")
def wire_bundle():
    """The JAX package's (5, 1) dpermcheck bundle and public data, and the
    same carried into the port."""
    T, J = bls12_381_g1("cpu"), jg1.bls12_381_g1()
    n, l = 5, 1
    N = 8 * l
    jnet = JaxNet(N, mode="sim")
    jpp = JaxPSS(J.fr, l)
    jd = jax_honest_srs(J, n + 2, n_parties=N, seed=41)
    jc = jpc.srs_packed(jax_honest_srs(J, n + 2, seed=43), jpp)
    jpk, jg = jparams.consistent_proving_parameters(n, l, jnet, srs={"c": jc, "d": jd}, curve=J)
    jwire = jcollab.dpermcheck(n, jpk, jnet, c=C)
    eq_top = eq_top_table(T.fr, N, "dpermcheck")
    jeq_top = jnp.asarray(convert.to_numpy(eq_top))
    jax_side = {"pp": jpp, "d": jd, "wire": jwire, "eq_r2": jg["eq_r2"], "eq_top": jeq_top,
                "ch2": jpk.challenge_r2, "F": J.fr}
    port = {"pp": PackedSharingParams(T.fr, l), "d": convert.srs_from_numpy(T, jd),
            "wire": convert.bundle_from_numpy(jwire, "cpu"), "eq_r2": _t(jg["eq_r2"]),
            "eq_top": eq_top, "ch2": _t(jpk.challenge_r2)}
    return jax_side, port


def test_verify_dhyperplonk_wire_dpermcheck(wire_bundle):
    """The complete wire section, pairings included."""
    _, s = wire_bundle
    assert verify.verify_dhyperplonk_wire(s["pp"], s["d"], s["wire"], s["eq_r2"], s["eq_top"],
                                          s["ch2"]) == (True, [])


def _layer_message(j):
    wp, wc, wo = j["wire"]
    bad = list(wp)
    bad[7] = bad[7].at[0, 1, 0].add(1)
    return (bad, wc, wo), "layers", lambda fails: all("layer[2]" in f for f in fails)


def _layer_open(j):
    wp, wc, wo = j["wire"]
    bad = list(wo)
    dval, dpis = bad[9]  # layer 1 vx0
    bad[9] = (j["F"].add(dval, j["F"].const(1)), dpis)
    return (wp, wc, bad), "layers", lambda fails: any("layer[1]" in f for f in fails)


def _top_open(j):
    wp, wc, wo = j["wire"]
    bad = list(wo)
    dval, dpis = bad[-3]
    bad[-3] = (j["F"].add(dval, j["F"].const(1)), dpis)
    return (wp, wc, bad), "top", lambda fails: (
        any("top open[vx0]: pairing" in f for f in fails) and any("top[1]" in f for f in fails))


def _run(mod, part: str, s: dict, wire):
    if part == "layers":
        return mod.verify_dhyperplonk_wire_layers(s["pp"], wire, s["eq_r2"], s["ch2"])
    return mod.verify_dhyperplonk_wire_top(s["pp"], s["d"], wire, s["eq_top"], s["ch2"])


@pytest.mark.parametrize("corrupt", [_layer_message, _layer_open, _top_open],
                         ids=["layer_message", "layer_open", "top_open"])
def test_verify_wire_corrupted(wire_bundle, corrupt):
    """tests/test_hyperplonk.py:372-394: each corruption is caught by its
    part, with the JAX verifier's failures."""
    j, s = wire_bundle
    bad, part, expected = corrupt(j)
    want = _run(jverify, part, j, bad)
    got = _run(verify, part, s, convert.bundle_from_numpy(bad, "cpu"))
    assert not want[0] and expected(want[1]), want
    assert got == want
