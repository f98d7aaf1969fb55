"""The port's collaborative HyperPlonk prove as a whole, on the CPU (slow).

Every MSM here runs through the plain versions, so a whole prove takes
minutes on the CPU; the card runs the same (6, 1) check in both MSM
configurations in ``chip_smoke.py``.  Checks:

* the (6, 1) leader-mode prove's canonical digest is the JAX package's pin;
* at (4, 1) the party-net counters of one prove equal the JAX package's
  pins in leader mode and in sim mode (the latter with the layered
  zerocheck run layer by layer);
* at (6, 1), on the JAX package's inputs carried across, the commit step
  and the final opens equal the JAX package's step by step (points by
  affine value, field values bit for bit), so a mismatch names its step.
"""

import numpy as np
import pytest

from scalable_collaborative_zksnark_tpu.hyperplonk import collaborative as jcollab
from scalable_collaborative_zksnark_tpu.hyperplonk import params as jparams
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu_torch import bench, convert
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import packed_proving_parameters
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.utils.digest import proof_digest

pytestmark = pytest.mark.slow


def test_prove_digest_n6_l1():
    net = PartyNet(8, "leader")
    pk = packed_proving_parameters(6, 1, net, device="cpu")
    assert proof_digest(pk.curve, collaborative.dhyperplonk(6, pk, net)) == bench.PINS[(6, 1)]


@pytest.mark.parametrize("mode", ["leader", "sim"])
def test_prove_comm_n4_l1(mode):
    """tests/test_hyperplonk.py's pins: party 0 (44465, 46593), all parties
    (102152, 102152) each way, in both modes."""
    net = PartyNet(8, mode)
    pk = packed_proving_parameters(4, 1, net, device="cpu")
    collaborative.dhyperplonk(4, pk, net, per_layer=mode == "sim")
    assert net.comm(0) == (44465, 46593)
    assert net.comm_total() == (102152, 102152)


def _same(T, J, got, want):
    """Field tables bit for bit, points by affine value, through nested
    tuples and lists."""
    if isinstance(got, PointJ):
        assert T.to_affine_ints(got) == J.to_affine_ints(want)
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(T, J, g, w)
    else:
        np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


def test_steps_n6_l1():
    """``_commit_step`` and ``_final_opens`` on one set of inputs (the JAX
    package's, carried across), and their counters."""
    jnet = JaxNet(8, "leader")
    jpk = jparams.packed_proving_parameters(6, 1, jnet)
    pk = convert.proving_parameters_from_numpy(jpk, "cpu")
    net = PartyNet(8, "leader")
    T, J = pk.curve, jpk.curve
    coms = collaborative._commit_step(pk, net, 8)
    jcoms = jcollab._commit_step(jpk, jnet, 8)
    _same(T, J, list(coms), list(jcoms))
    assert (net.up, net.down, net.rounds) == (jnet.up, jnet.down, jnet.rounds)
    _same(T, J, collaborative._final_opens(pk, net, coms, 8),
          jcollab._final_opens(jpk, jnet, jcoms, 8))
    assert (net.up, net.down, net.rounds) == (jnet.up, jnet.down, jnet.rounds)
