"""Whole proves with the party axis spread over four gloo ranks (slow).

The counterparts of ``tests/test_sharding.py``'s prover cases and of
``tests/test_multihost.py``, on the CPU through the plain versions, where
a single-process sim prove at (4, 1) takes minutes:

* ``dhyperplonk`` at (4, 1): the gathered bundle's canonical digest equals
  the JAX package's sim bundle's and the single-process port sim run's
  (``PORT_SIM_DIGESTS``), and every rank's comm equals the single-process
  net's pins; the inputs carried across from the JAX package by
  ``convert`` (the rank's rows) equal those the rank draws itself;
* ``cpermcheck`` at (4, 1), whose all-to-all transposes only a split run
  exercises, against its sim digests;
* ``dhyperplonk`` at (6, 2), 16 parties over 4 ranks;
* ``run_multihost --local-demo --digest`` equals the one-process digest.

The ranks import this module, so it imports neither JAX nor the JAX
package at its top.
"""

import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative, sharding
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import packed_proving_parameters
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.utils.digest import proof_digest

pytestmark = pytest.mark.slow

WORLD = 4
REPO = Path(__file__).resolve().parents[1]
# the single-process port sim run's digests (and the JAX package's, which
# the tests compute) at (4, 1)
PORT_SIM_DIGESTS = {"dhyperplonk": 0x28B67B9427626154, "cpermcheck": 0xE4D9BCD48A615FD6}


def _host_srs(srs):
    """A JAX SRS as numpy and host values (what ``convert`` takes)."""
    pts = lambda lv: None if lv is None else (  # noqa: E731
        {k: pts(v) for k, v in lv.items()} if isinstance(lv, dict)
        else [tuple(np.asarray(a) for a in pt) for pt in lv])
    return types.SimpleNamespace(
        powers_of_g=pts(srs.powers_of_g), powers_of_g2=list(srs.powers_of_g2),
        party_weights=srs.party_weights, root_levels=pts(srs.root_levels),
        packed_powers=pts(srs.packed_powers), affine=bool(srs.affine))


def _host_pk(jpk):
    """The JAX package's inputs with no JAX type left, for the ranks."""
    out = {}
    for f in dataclasses.fields(jpk):
        v = getattr(jpk, f.name)
        if f.name in ("c_commitment", "d_commitment"):
            v = _host_srs(v)
        elif f.name == "pp":
            v = types.SimpleNamespace(l=int(v.l))
        elif f.name == "curve":
            v = None
        elif f.name != "n":
            v = np.asarray(v)
        out[f.name] = v
    return types.SimpleNamespace(**out)


def rank_prove(group, device, n, l, names, host_pk=None):
    """On one rank: the inputs (drawn, and with ``host_pk`` also carried
    across, which must equal them), each prover of ``names`` once, the
    gathered bundle's digest and the comm."""
    net = PartyNet(8 * l, "sim", group=group)
    srs = None
    if host_pk is not None:
        carried = convert.proving_parameters_from_numpy(host_pk, device, net)
        srs = {"c": carried.c_commitment, "d": carried.d_commitment}
    pk = packed_proving_parameters(n, l, net, curve=bls12_381_g1(device), srs=srs)
    if host_pk is not None:
        for f in dataclasses.fields(pk):
            a, b = getattr(pk, f.name), getattr(carried, f.name)
            if torch.is_tensor(a):
                assert torch.equal(a, b), f.name
    out = {}
    for name in names:
        net.reset_comm()
        bundle = sharding.gather_bundle(getattr(collaborative, name)(n, pk, net), net, name,
                                        check_leader=True)
        out[name] = {"digest": proof_digest(pk.curve, bundle), "comm": net.comm(0),
                     "total": net.comm_total(), "rounds": net.rounds}
    return out


def _jax_sim(n, l, names):
    """The JAX package's sim bundles of ``names`` at (n, l), digested by the
    port (``convert.bundle_from_numpy``), their comm, and the inputs."""
    from scalable_collaborative_zksnark_tpu.hyperplonk import collaborative as jcollab
    from scalable_collaborative_zksnark_tpu.hyperplonk import params as jparams
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet

    jnet = JaxNet(8 * l, "sim")
    jpk = jparams.packed_proving_parameters(n, l, jnet)
    out = {}
    for name in names:
        jnet.reset_comm()
        bundle = getattr(jcollab, name)(n, jpk, jnet)
        out[name] = (proof_digest(bls12_381_g1("cpu"), convert.bundle_from_numpy(bundle, "cpu")),
                     jnet.comm(0))
    return out, jpk


@pytest.fixture(scope="module")
def n4_l1():
    """(the JAX package's digests and comm, the four ranks' reports)."""
    names = ("dhyperplonk", "cpermcheck")
    want, jpk = _jax_sim(4, 1, names)
    ranks = sharding.run_ranks(rank_prove, WORLD, "gloo", "cpu",
                               args=(4, 1, names, _host_pk(jpk)), timeout=1800)
    return want, ranks


def test_dhyperplonk_split_n4_l1(n4_l1):
    want, ranks = n4_l1
    assert want["dhyperplonk"] == (PORT_SIM_DIGESTS["dhyperplonk"], (44465, 46593))
    for rank in ranks:
        got = rank["dhyperplonk"]
        assert (got["digest"], got["comm"]) == want["dhyperplonk"]
        assert got["total"] == (102152, 102152)  # tests/test_torch_prove.py's pin


def test_cpermcheck_split_n4_l1(n4_l1):
    want, ranks = n4_l1
    assert want["cpermcheck"][0] == PORT_SIM_DIGESTS["cpermcheck"]
    for rank in ranks:
        assert (rank["cpermcheck"]["digest"], rank["cpermcheck"]["comm"]) == want["cpermcheck"]


def test_dhyperplonk_split_l2_16parties():
    """The counterpart of test_dhyperplonk_sharded_equal_l2_16parties: 16
    parties, four a rank."""
    want, _ = _jax_sim(6, 2, ("dhyperplonk",))
    ranks = sharding.run_ranks(rank_prove, WORLD, "gloo", "cpu", args=(6, 2, ("dhyperplonk",)),
                               timeout=2400)
    for rank in ranks:
        assert (rank["dhyperplonk"]["digest"], rank["dhyperplonk"]["comm"]) == want["dhyperplonk"]


def test_run_multihost_local_demo(tmp_path):
    """Four gloo processes and one process, the same digest."""
    script = [sys.executable, "-m",
              "scalable_collaborative_zksnark_tpu_torch.scripts.run_multihost",
              "--n", "4", "--l", "1", "--repeat", "0"]
    subprocess.run(script + ["--local-demo", "--digest", str(tmp_path / "demo.txt")], check=True,
                   timeout=1800, cwd=REPO)
    subprocess.run(script + ["--world-size", "1", "--device", "cpu", "--digest",
                             str(tmp_path / "single.txt")], check=True, timeout=1800, cwd=REPO)
    demo = (tmp_path / "demo.txt").read_text()
    assert demo.strip() == f"0x{PORT_SIM_DIGESTS['dhyperplonk']:016x}"
    assert demo == (tmp_path / "single.txt").read_text()
