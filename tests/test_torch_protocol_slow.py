"""Slow port parity of the protocol layer (each test takes minutes on the
CPU, so all are marked ``slow``):

* the three variants in leader mode at (4, 1) and (5, 1) against the JAX
  package's, bundle by canonical digest and the comm counters exactly;
* the port's own sim-mode ``dhyperplonk`` (4, 1) and ``dpermcheck`` (5, 1),
  proved from consistent shares on SRSs the port builds, verified by the
  port;
* the port's verifier on a JAX-made sim (5, 2) bundle, whose c_opens fail
  their pairings in both verifiers (at l > 1 their phase-2 proofs are the
  reference's local MSMs over the packed base);
* ``local_hyperplonkpp`` at n = 2 against the JAX package's;
* ``examples.permcheck --variant d`` printing the JAX example's comm bytes;
* the recomputation of ``chip_smoke.py``'s phase-8 pins from the JAX
  package (the local provers at n = 16, the variants at (16, 8)), in
  parallel processes.
"""

import concurrent.futures
import multiprocessing
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu.curves import g1 as jg1
from scalable_collaborative_zksnark_tpu.curves import host_curve as jhc
from scalable_collaborative_zksnark_tpu.hyperplonk import collaborative as jcollab
from scalable_collaborative_zksnark_tpu.hyperplonk import local as jlocal
from scalable_collaborative_zksnark_tpu.hyperplonk import params as jparams
from scalable_collaborative_zksnark_tpu.hyperplonk import verify as jverify
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu.primitives import poly_comm as jpc
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.examples import permcheck as pc_example
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative, local, params
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import verify
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives.poly_comm import srs_from_secret
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams
from scalable_collaborative_zksnark_tpu_torch.utils.digest import proof_digest

pytestmark = pytest.mark.slow

C = 4  # the JAX package's MSM window in its CPU tests
VARIANTS = {"dp": ("dhyperplonk_data_parallel", 4, 1), "dperm": ("dpermcheck", 4, 1),
            "cperm": ("cpermcheck", 5, 1)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions run many tiny tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _comm(net) -> tuple:
    return net.up[0], net.down[0], net.up[1], net.down[1], net.rounds


@pytest.mark.parametrize("kind", sorted(VARIANTS))
def test_variant_leader_equals_jax(kind):
    """Each variant's bundle and counters of one prove in leader mode."""
    name, n, l = VARIANTS[kind]
    T, J = bls12_381_g1("cpu"), jg1.bls12_381_g1()
    net, jnet = PartyNet(8 * l, "leader"), JaxNet(8 * l, "leader")
    pk = params.packed_proving_parameters(n, l, net, curve=T)
    jpk = jparams.packed_proving_parameters(n, l, jnet, curve=J)
    net.reset_comm()
    jnet.reset_comm()
    got = getattr(collaborative, name)(n, pk, net, c=C)
    want = getattr(jcollab, name)(n, jpk, jnet, c=C)
    assert _comm(net) == _comm(jnet)
    assert proof_digest(T, got) == proof_digest(T, convert.bundle_from_numpy(want, "cpu"))


def _secrets(n_vars: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(40), "little") % hc.R for _ in range(n_vars)]


def _sim_setup(n: int, d_seed: int, c_seed: int):
    T = bls12_381_g1("cpu")
    net = PartyNet(8, "sim")
    pp = PackedSharingParams(T.fr, 1)
    d = srs_from_secret(T, hc.G1_GEN, hc.G2_GEN, _secrets(n + 2, d_seed), n_parties=8)
    c_srs = srs_from_secret(T, hc.G1_GEN, hc.G2_GEN, _secrets(n + 2, c_seed), pp=pp)
    pk, g = params.consistent_proving_parameters(n, 1, net, {"c": c_srs, "d": d}, curve=T)
    return T, net, pp, d, c_srs, pk, g


def test_port_sim_dhyperplonk_verifies():
    """The port's sim-mode (4, 1) bundle, on the port's own honest SRSs."""
    T, net, pp, d, c_srs, pk, g = _sim_setup(4, 31, 37)
    proof = collaborative.dhyperplonk(4, pk, net, c=C)
    assert verify.verify_dhyperplonk(pp, c_srs, d, proof, g, pk.challenge, pk.challenge_r2,
                                     collaborative.eq_top_table(T.fr, 8)) == (True, [])


def test_port_sim_dpermcheck_verifies():
    """The port's sim-mode (5, 1) dpermcheck wire bundle (two layers)."""
    T, net, pp, d, _, pk, g = _sim_setup(5, 41, 43)
    wire = collaborative.dpermcheck(5, pk, net, c=C)
    eq_top = collaborative.eq_top_table(T.fr, 8, "dpermcheck")
    assert verify.verify_dhyperplonk_wire(pp, d, wire, g["eq_r2"], eq_top,
                                          pk.challenge_r2) == (True, [])


def test_verify_l2_bundle_matches_jax():
    """A JAX-made sim (5, 2) bundle: the JAX verifier reports the three
    c_open pairings (the reference's phase-2 simplification,
    dpoly_comm.rs:454-456) and the port's returns the same; without
    pairings both accept."""
    T, J = bls12_381_g1("cpu"), jg1.bls12_381_g1()
    n, l = 5, 2
    jnet, jpp = JaxNet(8 * l, mode="sim"), JaxPSS(J.fr, l)

    def honest(seed, parties=1):
        return jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, _secrets(n + 2, seed),
                                   n_parties=parties)
    jd, jc = honest(31, 8 * l), honest(37)
    jpk, jg = jparams.consistent_proving_parameters(
        n, l, jnet, srs={"c": jpc.srs_packed(jc, jpp), "d": jd}, curve=J)
    jproof = jcollab.dhyperplonk(n, jpk, jnet, c=C)
    eq_top = collaborative.eq_top_table(T.fr, 8 * l)
    jeq_top = jnp.asarray(convert.to_numpy(eq_top))
    t = lambda a: convert.from_numpy(np.asarray(a), "cpu")  # noqa: E731
    port_args = (PackedSharingParams(T.fr, l), convert.srs_from_numpy(T, jc),
                 convert.srs_from_numpy(T, jd), convert.bundle_from_numpy(jproof, "cpu"),
                 {k: t(v) for k, v in jg.items()}, t(jpk.challenge), t(jpk.challenge_r2), eq_top)
    jax_args = (jpp, jc, jd, jproof, jg, jpk.challenge, jpk.challenge_r2, jeq_top)
    want = jverify.verify_dhyperplonk(*jax_args)
    assert want == (False, chip_smoke.C_OPEN_PHASE2_FAILURES)
    assert verify.verify_dhyperplonk(*port_args) == want
    assert verify.verify_dhyperplonk(*port_args, pairings=False) == (True, [])


def test_local_hyperplonkpp_equals_jax():
    """local_hyperplonkpp at n = 2 (c = 4): the reference's counts (+1
    commit, +1 proof, +3 opens) and the JAX package's values."""
    T, J = bls12_381_g1("cpu"), jg1.bls12_381_g1()
    rng = np.random.RandomState(11)
    s = [int.from_bytes(rng.bytes(40), "little") % J.fr.p for _ in range(4)]
    jsrs = jpc.srs_from_secret(J, jhc.G1_GEN, jhc.G2_GEN, s)
    got = local.local_hyperplonkpp(2, convert.srs_from_numpy(T, jsrs), c=C)
    want = jlocal.local_hyperplonkpp(2, jsrs, c=C)
    (gp, gc), (wp, wc, wo) = got
    assert (len(gp), len(gc), len(wp), len(wc), len(wo)) == (6, 6, 7, 9, 11)
    assert proof_digest(T, got) == proof_digest(T, convert.bundle_from_numpy(want, "cpu"))


def test_permcheck_example_comm(capsys):
    """``examples.permcheck --variant d --n 4 --l 1`` prints the JAX
    example's comm bytes (its ``dpermcheck`` after ``reset_comm``)."""
    jnet = JaxNet(8, mode="leader")
    jpk = jparams.packed_proving_parameters(4, 1, jnet)
    jcollab.dpermcheck(4, jpk, jnet)
    jnet.reset_comm()
    jcollab.dpermcheck(4, jpk, jnet)
    up, down = jnet.comm(0)
    pc_example.main(["--variant", "d", "--n", "4", "--l", "1", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(rf"dpermcheck n=4 l=1 mode=leader: \d+\.\d{{3}} s, comm up={up} "
                        rf"down={down}", line), line


def _jax_pin(kind: str):
    """A phase-8 pin from the JAX package on the CPU, in a fresh process:
    (canonical digest, comm of one prove or None)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from scalable_collaborative_zksnark_tpu.utils.benchlib import proof_digest as jax_digest

    J = jg1.bls12_381_g1()
    n, l = chip_smoke.PROTOCOL["n"], chip_smoke.PROTOCOL["l"]
    if kind in ("local", "localpp"):
        srs = jpc.srs_random(J, n + 2, chip_smoke.PROTOCOL["local_srs_seed"])
        fn = jlocal.local_hyperplonk if kind == "local" else jlocal.local_hyperplonkpp
        return jax_digest(fn(n, srs)), None
    net = JaxNet(8 * l, mode="leader")
    pk = jparams.packed_proving_parameters(n, l, net)
    net.reset_comm()
    out = getattr(jcollab, VARIANTS[kind][0])(n, pk, net)
    return jax_digest(out), _comm(net)


def test_chip_smoke_protocol_pins():
    """Recompute chip_smoke.py's phase-8 pins from the JAX package on the
    CPU: the local provers at n = 16 on srs_random(curve, 18, 7) and the
    three variants at (16, 8) in leader mode (digest, and comm of one
    prove), five processes at once."""
    kinds = ["local", "localpp", "dp", "dperm", "cperm"]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(kinds), mp_context=ctx) as ex:
        results = dict(zip(kinds, ex.map(_jax_pin, kinds)))
    n, l = chip_smoke.PROTOCOL["n"], chip_smoke.PROTOCOL["l"]
    for kind, (digest, comm) in results.items():
        key = f"{kind}_n{n}" + ("" if comm is None else f"_l{l}")
        assert digest == chip_smoke.PINS[key], kind
        if comm is not None:
            assert comm == chip_smoke.PINS[f"{key}_comm"], kind
