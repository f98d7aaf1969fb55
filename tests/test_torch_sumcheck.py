"""Port parity: the sumcheck family and its fold-phase kernel.

Same seeded inputs through the JAX package (its unfused round loop on the
CPU, or its Pallas phase kernel in interpret mode) and the port (the plain
version of the phase kernel on the CPU).  Exact equality of transcripts
and of the party-net byte and round counters.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu.fields.fr import get_field as jax_field
from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
from scalable_collaborative_zksnark_tpu.primitives import sumcheck as jsc
from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.convert import to_numpy
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import cuda_sumcheck
from scalable_collaborative_zksnark_tpu_torch.primitives import sumcheck as sc
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams
from scalable_collaborative_zksnark_tpu_torch.utils.digest import limb_digest

NAME = "bls12_381_fr"
N_VARS = 6
from_numpy = functools.partial(convert.from_numpy, device="cpu")


@pytest.fixture()
def cuda():
    """The card, or a skip; decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def fields():
    return get_field(NAME, device="cpu"), jax_field(NAME)


@pytest.fixture(scope="module")
def data(fields):
    """Two 2^6-evaluation tables and N_VARS + 4 challenges (numpy uint32)."""
    _, JF = fields
    M = 1 << N_VARS
    return tuple(np.asarray(JF.random(shape, seed))
                 for shape, seed in (((M,), 61), ((M,), 62), ((N_VARS + 4,), 63)))


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _counters(net):
    return net.up, net.down, net.rounds


def _jax(fn, *args):
    """Run a JAX package function under one jit (one compile instead of one
    per op and shape); its party-net counters tick once, at trace time."""
    return jax.jit(fn)(*args)


def _phase_equal(port, jax_out):
    (pm, pf, pg), (jm, jf, jg) = port, jax_out
    assert len(pm) == len(jm)
    for a, b in zip(pm + [pf, pg], list(jm) + [jf, jg]):
        _eq(a, b)


@functools.lru_cache(maxsize=None)
def _jax_phase(M):
    """Inputs [6, M] and the JAX round loop's outputs on them.  Row 0 of
    a ``random((6, M))`` draw equals ``random((1, M))`` with the same seed,
    so the B = 1 case reads slot 0 of the same run."""
    JF = jax_field(NAME)
    f, g, ch = (np.asarray(JF.random(s, seed))
                for s, seed in (((6, M), 71), ((6, M), 72), ((12,), 73)))
    R = M.bit_length() - 1
    return (f, g, ch), _jax(lambda *a: jsc._rounds_product(JF, *a, 1, R), f, g, ch)


@pytest.mark.parametrize("M", [1 << 6, 1 << 7, 1 << 8])
@pytest.mark.parametrize("B", [1, 6])
def test_plain_phase_vs_jax_rounds(fields, M, B):
    F, JF = fields
    (f, g, ch), (jm, jf, jg) = _jax_phase(M)
    np.testing.assert_array_equal(np.asarray(JF.random((B, M), 71)), f[:B])
    port = cuda_sumcheck.product_phase(F, from_numpy(f[:B]), from_numpy(g[:B]), from_numpy(ch), 1)
    _phase_equal(port, ([np.asarray(m)[:B] for m in jm], np.asarray(jf)[:B], np.asarray(jg)[:B]))


def test_partial_product_rounds(fields, data):
    """Fewer rounds than log2 M take the unfused loop."""
    F, JF = fields
    f, g, ch = data
    port = sc._rounds_product(F, from_numpy(f), from_numpy(g), from_numpy(ch), 2, 3)
    _phase_equal(port, _jax(lambda *a: jsc._rounds_product(JF, *a, 2, 3), f, g, ch))


@pytest.mark.parametrize("fn", ["sumcheck", "sumcheck_product"])
def test_local_variants(fields, data, fn):
    F, JF = fields
    f, g, ch = data
    if fn == "sumcheck":
        _eq(sc.sumcheck(F, from_numpy(f), from_numpy(ch)),
            _jax(lambda *a: jsc.sumcheck(JF, *a), f, ch))
    else:
        _eq(sc.sumcheck_product(F, from_numpy(f), from_numpy(g), from_numpy(ch)),
            _jax(lambda *a: jsc.sumcheck_product(JF, *a), f, g, ch))


def _shares(jpp, x, M):
    """numpy [M, L] secrets -> [N, M/l, L] party-major shares (JAX pack)."""
    return np.moveaxis(np.asarray(jpp.pack_from_public(x.reshape(M // jpp.l, jpp.l, -1))), -2, 0)


CONFIGS = [("sim", 1), ("sim", 2), ("leader", 2)]


@pytest.mark.parametrize("mode,l", CONFIGS)
@pytest.mark.parametrize("fn", ["c_sumcheck", "c_sumcheck_product"])
def test_collaborative_variants(fields, data, mode, l, fn):
    F, JF = fields
    f, g, ch = data
    M = f.shape[0]
    pp, jpp = PackedSharingParams(F, l), JaxPSS(JF, l)
    net, jnet = PartyNet(pp.n, mode), JaxNet(jpp.n, mode)
    P = net.local_parties
    sf, sg = _shares(jpp, f, M)[:P], _shares(jpp, g, M)[:P]
    if fn == "c_sumcheck":
        got = sc.c_sumcheck(pp, net, from_numpy(sf), from_numpy(ch))
        want = _jax(lambda *a: jsc.c_sumcheck(jpp, jnet, *a), sf, ch)
    else:
        got = sc.c_sumcheck_product(pp, net, from_numpy(sf), from_numpy(sg), from_numpy(ch))
        want = _jax(lambda *a: jsc.c_sumcheck_product(jpp, jnet, *a), sf, sg, ch)
    _eq(got, want)
    assert _counters(net) == _counters(jnet)


@pytest.mark.parametrize("mode,l", CONFIGS)
@pytest.mark.parametrize("fn", ["d_sumcheck", "d_sumcheck_product"])
def test_distributed_variants(fields, data, mode, l, fn):
    F, JF = fields
    f, g, ch = data
    N = 8 * l
    net, jnet = PartyNet(N, mode), JaxNet(N, mode)
    P = net.local_parties
    pf, pg = f.reshape(N, -1, f.shape[-1])[:P], g.reshape(N, -1, g.shape[-1])[:P]
    if fn == "d_sumcheck":
        got = sc.d_sumcheck(F, net, from_numpy(pf), from_numpy(ch))
        want = _jax(lambda *a: jsc.d_sumcheck(JF, jnet, *a), pf, ch)
    else:
        got = sc.d_sumcheck_product(F, net, from_numpy(pf), from_numpy(pg), from_numpy(ch))
        want = _jax(lambda *a: jsc.d_sumcheck_product(JF, jnet, *a), pf, pg, ch)
    _eq(got, want)
    assert _counters(net) == _counters(jnet)


def test_gate_identity_batched_shape(fields):
    """The prove's gate-identity call: six table pairs in one batched
    c_sumcheck_product, [1, 6, M, L], leader mode."""
    F, JF = fields
    l = 2
    pp, jpp = PackedSharingParams(F, l), JaxPSS(JF, l)
    net, jnet = PartyNet(pp.n, "leader"), JaxNet(jpp.n, "leader")
    f, g, ch = (np.asarray(JF.random(s, seed))
                for s, seed in (((1, 6, 16), 81), ((1, 6, 16), 82), ((9,), 83)))
    got = sc.c_sumcheck_product(pp, net, from_numpy(f), from_numpy(g), from_numpy(ch))
    _eq(got, _jax(lambda *a: jsc.c_sumcheck_product(jpp, jnet, *a), f, g, ch))
    assert tuple(got.shape) == (1, 6, 4 + 1 + 1, 3, F.L)
    assert _counters(net) == _counters(jnet)


def test_collaborative_transcript_verifies(fields, data):
    """Sim mode: transcripts opened with unpack2 equal the monolithic one
    and pass the round-consistency verifier."""
    F, JF = fields
    f, g, ch = data
    M = f.shape[0]
    l = 2
    pp, jpp = PackedSharingParams(F, l), JaxPSS(JF, l)
    net = PartyNet(pp.n)
    msgs = sc.c_sumcheck_product(pp, net, from_numpy(_shares(jpp, f, M)),
                                 from_numpy(_shares(jpp, g, M)), from_numpy(ch))
    opened = F.sum(pp.unpack2(msgs.movedim(0, -2)), axis=-2)
    _eq(opened, sc.sumcheck_product(F, from_numpy(f), from_numpy(g), from_numpy(ch)))
    proof = [tuple(int(v) for v in row) for row in F.array_to_ints(opened)]
    h = sum(x * y for x, y in zip(JF.array_to_ints(f), JF.array_to_ints(g))) % F.p
    ch_ints = [int(v) for v in JF.array_to_ints(ch)]
    assert sc.check_sumcheck_product(F, h, proof, ch_ints)
    assert not sc.check_sumcheck_product(F, h + 1, proof, ch_ints)
    assert net.rounds == 4  # two pss2ss: one gather + one scatter each


def test_gate_identity_pin_on_cpu():
    """The port's CPU path reproduces chip_smoke.py's pinned gate-identity digest."""
    F = get_field(NAME, device="cpu")
    _, _, run = chip_smoke.gate_identity(F)
    assert limb_digest(run()) == chip_smoke.PINS["gate"]


@pytest.mark.slow
def test_plain_phase_vs_pallas_interpret(fields, monkeypatch):
    """The plain phase against the TPU phase kernel under the Pallas
    interpreter (minutes of XLA:CPU compile)."""
    from scalable_collaborative_zksnark_tpu.primitives import pallas_sumcheck as psc

    monkeypatch.setenv("SCZK_PALLAS_INTERPRET", "1")
    F, JF = fields
    B, M = 2, 128
    f, g, ch = (JF.random(s, seed) for s, seed in (((B, M), 91), ((B, M), 92), ((10,), 93)))
    port = cuda_sumcheck.product_phase(F, *(from_numpy(np.asarray(x)) for x in (f, g, ch)), 1)
    _phase_equal(port, psc.product_phase(JF, f, g, ch, 1))


@pytest.mark.slow
def test_chip_smoke_pins(fields):
    """Recompute chip_smoke.py's pins from the JAX package on the CPU (the
    same seeds and digest code); this is how they were made."""
    pins = _chip_smoke_pins(fields[1])
    assert pins == {k: chip_smoke.PINS[k] for k in pins}


def _chip_smoke_pins(JF) -> dict:
    cs = chip_smoke

    def inputs(cfg, shape):
        sf, sg, sch = cfg["seeds"]
        return JF.random(shape, sf), JF.random(shape, sg), JF.random((cfg["n"] + 4,), sch)

    def leader_c(cfg, batch=()):
        jpp = JaxPSS(JF, cfg["l"])
        net = JaxNet(jpp.n, "leader")
        args = inputs(cfg, (1,) + batch + ((1 << cfg["n"]) // cfg["l"],))
        return _jax(lambda *a: jsc.c_sumcheck_product(jpp, net, *a), *args)

    pins = {
        "gate": limb_digest(np.asarray(leader_c(cs.GATE, (cs.GATE["batch"],)))),
        "envelope": limb_digest(np.asarray(leader_c(cs.ENVELOPE))),
    }
    args = inputs(cs.LOCAL, (1 << cs.LOCAL["n"],))
    pins["local"] = limb_digest(np.asarray(_jax(lambda *a: jsc.sumcheck_product(JF, *a), *args)))
    cfg = cs.SIM
    jpp = JaxPSS(JF, cfg["l"])
    net = JaxNet(jpp.n, "sim")
    M = 1 << cfg["n"]
    f, g, ch = inputs(cfg, (M,))
    shares = [_shares(jpp, np.asarray(x), M) for x in (f, g)]
    _jax(lambda *a: jsc.c_sumcheck_product(jpp, net, *a), *shares, ch)
    pins["sim_comm"] = cs._comm(net)
    return pins


@pytest.mark.gpu
def test_phase_kernel_matches_plain_on_card(cuda):
    F = get_field(NAME, device=cuda)
    for B, M in ((1, 2), (6, 128), (2, 4096)):
        f, g, ch = F.random((B, M), 1), F.random((B, M), 2), F.random((16,), 3)
        km, kf, kg = cuda_sumcheck.product_phase(F, f, g, ch, 2)
        pm, pf, pg = cuda_sumcheck.product_phase_plain(F.spec, f, g, ch, 2)
        for a, b in zip(km + [kf, kg], pm + [pf, pg]):
            assert torch.equal(a, b)
