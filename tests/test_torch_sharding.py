"""The party axis spread over processes: four gloo ranks on the CPU.

One world of 4 processes (``sharding.run_ranks``, ``spawn``) holds the N =
8 parties of l = 1, two a rank, and runs every case below once, on seeded
inputs.  Each rank's rows are held against the single-process port sim
run and against the JAX package's sim run of the same inputs (the cases
of ``tests/test_sharding.py``): field values bit for bit, points by affine
value; every rank's party-net counters equal the single-process ones.

The ranks import this module, so it imports neither JAX nor the JAX
package at its top: the references import them inside their fixtures.
"""

import concurrent.futures
import dataclasses
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.curves import host_curve as hc
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1
from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative, sharding
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import (
    PARTY_FIELDS, load_srs_cache, map_levels, packed_proving_parameters, save_srs_cache)
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.primitives import msm
from scalable_collaborative_zksnark_tpu_torch.primitives.acc_product import (
    c_acc_product_and_share)
from scalable_collaborative_zksnark_tpu_torch.primitives.poly_comm import (PolynomialCommitment,
                                                                          _packed_base)
from scalable_collaborative_zksnark_tpu_torch.primitives.sumcheck import c_sumcheck_product
from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams

WORLD, L = 4, 1
N = 8 * L
P = N // WORLD
SUMCHECK_M, MSM_M, MSM_C, ACC_S = 32, 16, 4, 64
SHARD_NL = (4, 1)


def _np(x):
    """A tensor or a point as numpy (a point: its x, y, z)."""
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    return x.detach().cpu().numpy()


def _counters(net):
    return list(net.up), list(net.down), net.rounds


def _msm_inputs(curve, net):
    """tests/test_sharding.py's d_msm case: the net's rows of N x M points
    G * k and of the scalars ``Fr.decode(Fr.random((N, 1, M), 33))``."""
    rng = np.random.RandomState(31)
    ks = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(N * MSM_M)]
    rows = ks[net.party_offset * MSM_M:(net.party_offset + net.local_parties) * MSM_M]
    pts = curve.from_affine_ints([hc.g1_mul(hc.G1_GEN, k) for k in rows])
    bases = PointJ(*(a.reshape(net.local_parties, 1, MSM_M, -1) for a in pts))
    return bases, curve.fr.decode(net.random_rows(curve.fr, (1, MSM_M), 33))


def cases(net: PartyNet) -> dict:
    """Every case on ``net``'s parties (the CPU), as numpy."""
    curve = bls12_381_g1("cpu")
    F = curve.fr
    pp = PackedSharingParams(F, L)
    out = {}

    # the net's data paths: rows, all-gather, scatter, transpose, points
    x = net.random_rows(F, (3,), 5)  # [P, 3, L]
    y = net.random_rows(F, (N, 2), 6)  # [P, N, 2, L]: a block for every party
    out["net"] = {
        "gather": _np(net.gather_to_root(x, "fr", count=3, vec=True)),
        "scatter": _np(net.scatter_from_root(F.random((N, 4), 7), "fr", count=4)),
        "transpose": _np(net.transpose_parties(y, 1)),
        "points": _np(net.gather_data_only(PointJ(x, x + 1, x + 2))),
        "rows": _np(net.party_rows(torch.arange(N))),
    }
    net.all_to_all_rotating_root("fr", count_per_root=2, vec=True)
    net.sync()
    out["net"]["counters"] = _counters(net)

    net.reset_comm()
    out["exchange_s"] = _np(collaborative._exchange_s(F, net, net.random_rows(F, (4,), 9)))
    out["exchange_s_counters"] = _counters(net)

    # the per-party weights of an honest SRS, and d_msm's pre-scale
    srs = dataclasses.replace(srs_stub(curve), party_weights={
        4: np.asarray([(k * 7919 + 3) % hc.R for k in range(N)], dtype=object)})
    g = curve.from_affine_ints([hc.g1_mul(hc.G1_GEN, k + 2) for k in range(net.local_parties)])
    out["scaled"] = _np(srs._scale_by_weights(net, g, 4))
    out["prescale"] = _np(msm._dmsm_prescale(pp, net, F.decode(net.random_rows(F, (1, 3), 11))))

    net.reset_comm()
    ch = F.random((SUMCHECK_M.bit_length() - 1 + max(L.bit_length() - 1, 1),), 23)
    out["c_sumcheck_product"] = _np(c_sumcheck_product(
        pp, net, net.random_rows(F, (SUMCHECK_M,), 21), net.random_rows(F, (SUMCHECK_M,), 22),
        ch))
    out["c_sumcheck_product_counters"] = _counters(net)

    net.reset_comm()
    out["d_msm"] = _np(msm.d_msm(curve, pp, net, *_msm_inputs(curve, net), c=MSM_C))
    out["d_msm_counters"] = _counters(net)

    net.reset_comm()
    ins = [net.random_rows(F, (ACC_S,), k) for k in (41, 42, 43, 44, 45)]
    out["c_acc_product_and_share"] = [_np(t) for t in c_acc_product_and_share(pp, net, *ins)]
    out["c_acc_product_and_share_counters"] = _counters(net)
    return out


def srs_stub(curve):
    """An SRS without points, for the parts of it a case reads."""
    return PolynomialCommitment(curve, [], [])


def _host_inputs(pk) -> types.SimpleNamespace:
    """The port's inputs on the host as the JAX package's are handed across:
    ``uint32`` limb arrays, SRS levels as (x, y, z) of them."""
    u32 = lambda pt: tuple(convert.to_numpy(a) for a in pt)  # noqa: E731
    out = {}
    for f in dataclasses.fields(pk):
        v = getattr(pk, f.name)
        if torch.is_tensor(v):
            v = convert.to_numpy(v)
        elif isinstance(v, PolynomialCommitment):
            v = types.SimpleNamespace(
                powers_of_g=map_levels(v.powers_of_g, u32), powers_of_g2=v.powers_of_g2,
                party_weights=v.party_weights, root_levels=map_levels(v.root_levels, u32),
                packed_powers=map_levels(v.packed_powers, u32), affine=v.affine)
        out[f.name] = v
    return types.SimpleNamespace(**out)


def shard_case(net: PartyNet) -> dict:
    """``shard_parameters`` at (4, 1) on the whole inputs held on the host,
    through ``convert.proving_parameters_from_numpy``, against the inputs
    drawn for the net's parties alone; and the packed base of a per-party
    packed level on both."""
    curve = bls12_381_g1("cpu")
    n, l = SHARD_NL
    # an SRS of two packed levels: a flat one (the benchmark SRS's kind)
    # and a per-party one (srs_packed's), of random limbs
    rng = np.random.RandomState(3)
    flat, party = (PointJ(*(torch.from_numpy(rng.randint(0, 1 << 16, size=shape + (24,)).astype(
        np.int32)) for _ in range(3))) for shape in ((2,), (N, 2)))
    srs = {"c": dataclasses.replace(srs_stub(curve), packed_powers=[flat, party]),
           "d": dataclasses.replace(srs_stub(curve), root_levels={4: [flat]},
                                    party_weights={4: np.arange(N, dtype=object)})}
    whole = packed_proving_parameters(n, l, PartyNet(N, "sim"), curve=curve, srs=srs)
    cut = convert.proving_parameters_from_numpy(_host_inputs(whole), "cpu", net)
    drawn = packed_proving_parameters(n, l, net, curve=curve, srs=srs)
    with tempfile.TemporaryDirectory() as tmp:  # the SRS file a split prove's ranks load
        path = Path(tmp) / "srs.pkl"
        save_srs_cache(path, srs)
        loaded = load_srs_cache(path, curve, net)
    names = [f.name for f in dataclasses.fields(cut)
             if torch.is_tensor(getattr(cut, f.name))]
    entries = 2  # the per-party level's (l = 1)
    return {"cut": {k: _np(getattr(cut, k)) for k in names},
            "drawn": {k: _np(getattr(drawn, k)) for k in names},
            "whole": {k: _np(getattr(whole, k)) for k in names},
            "base_cut": _np(_packed_base(cut.c_commitment, cut.pp, net, entries)),
            "base_whole": _np(_packed_base(whole.c_commitment, whole.pp, net, entries)),
            "packed_offset": cut.c_commitment.packed_offset,
            "loaded": [_np(pt) for pt in loaded["c"].packed_powers],
            "loaded_offset": loaded["c"].packed_offset,
            "loaded_root": _np(loaded["d"].root_levels[4][0]),
            "cut_levels": [_np(pt) for pt in cut.c_commitment.packed_powers]}


def rank_main(group, device):
    net = PartyNet(N, "sim", group=group)
    return {"offset": net.party_offset, "local": net.local_parties, "cases": cases(net),
            "shard": shard_case(net)}


@pytest.fixture(scope="module")
def world():
    """The four ranks, started at once: the references are computed here
    while they run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(sharding.run_ranks, rank_main, WORLD, "gloo", "cpu", timeout=600)


@pytest.fixture(scope="module")
def ranks(world, single, jax_ref):
    return world.result()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single():
    """The single-process port sim run of the same cases."""
    return cases(PartyNet(N, "sim"))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's sim run of the three primitives of
    tests/test_sharding.py, on the same inputs."""
    import jax

    from scalable_collaborative_zksnark_tpu.curves.g1 import bls12_381_g1 as jax_curve
    from scalable_collaborative_zksnark_tpu.fields.fr import get_field as jax_field
    from scalable_collaborative_zksnark_tpu.mpc.net import PartyNet as JaxNet
    from scalable_collaborative_zksnark_tpu.primitives.acc_product import (
        c_acc_product_and_share as j_acc)
    from scalable_collaborative_zksnark_tpu.primitives.msm import d_msm as j_d_msm
    from scalable_collaborative_zksnark_tpu.primitives.sumcheck import (
        c_sumcheck_product as j_sumcheck)
    from scalable_collaborative_zksnark_tpu.pss.pss import PackedSharingParams as JaxPSS

    JF, JC = jax_field("bls12_381_fr"), jax_curve()
    jpp = JaxPSS(JF, L)
    out = {}
    net = JaxNet(N)  # counts while the jitted functions trace, once each
    ch = JF.random((SUMCHECK_M.bit_length() - 1 + max(L.bit_length() - 1, 1),), 23)
    out["c_sumcheck_product"] = np.asarray(jax.jit(lambda f, g: j_sumcheck(jpp, net, f, g, ch))(
        JF.random((N, SUMCHECK_M), 21), JF.random((N, SUMCHECK_M), 22)))
    out["c_sumcheck_product_counters"] = _counters(net)

    rng = np.random.RandomState(31)
    ks = [int.from_bytes(rng.bytes(31), "little") % hc.R for _ in range(N * MSM_M)]
    pts = JC.from_affine_ints([hc.g1_mul(hc.G1_GEN, k) for k in ks])
    bases = jax.tree.map(lambda a: a.reshape(N, 1, MSM_M, -1), pts)
    net = JaxNet(N)
    got = j_d_msm(JC, jpp, net, bases, JF.decode(JF.random((N, 1, MSM_M), 33)), c=MSM_C)
    out["d_msm"] = tuple(np.asarray(a) for a in got)
    out["d_msm_counters"] = _counters(net)

    net = JaxNet(N)
    ins = [JF.random((N, ACC_S), k) for k in (41, 42, 43, 44, 45)]
    got = jax.jit(lambda *a: j_acc(jpp, net, *a))(*ins)
    out["c_acc_product_and_share"] = [np.asarray(t) for t in got]
    out["c_acc_product_and_share_counters"] = _counters(net)
    return out


def _affine(pt) -> list:
    return bls12_381_g1("cpu").to_affine_ints(convert.points_from_numpy(
        [np.ascontiguousarray(a).view(np.uint32) for a in pt], "cpu"))


def _rows(whole, r):
    return whole[r["offset"]:r["offset"] + r["local"]]


def _limbs(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def test_net_data_paths_and_counters(ranks, single):
    want = single["net"]
    for r in ranks:
        got = r["cases"]["net"]
        assert r["local"] == P and r["offset"] == P * ranks.index(r)
        np.testing.assert_array_equal(got["gather"], want["gather"])  # every party, in order
        np.testing.assert_array_equal(got["points"][0], want["points"][0])
        np.testing.assert_array_equal(got["points"][2], want["points"][2])
        np.testing.assert_array_equal(got["scatter"], _rows(want["scatter"], r))
        np.testing.assert_array_equal(got["transpose"], _rows(want["transpose"], r))
        np.testing.assert_array_equal(got["rows"], _rows(want["rows"], r))
        assert got["counters"] == want["counters"]


def test_exchange_s(ranks, single):
    for r in ranks:
        np.testing.assert_array_equal(r["cases"]["exchange_s"], _rows(single["exchange_s"], r))
        assert r["cases"]["exchange_s_counters"] == single["exchange_s_counters"]


def test_weight_and_prescale_offsets(ranks, single):
    """Party p's point scales by w_p and its d_msm scalars by its own w_j:
    a rank that read rows from 0 would scale the wrong parties."""
    weights = [(k * 7919 + 3) % hc.R for k in range(N)]
    assert _affine(single["scaled"]) == [hc.g1_mul(hc.G1_GEN, (k + 2) * weights[k] % hc.R)
                                         for k in range(N)]
    for r in ranks:  # the rank's points are G * (k + 2), k < P
        want = [hc.g1_mul(hc.G1_GEN, (k + 2) * weights[r["offset"] + k] % hc.R) for k in range(P)]
        assert _affine(r["cases"]["scaled"]) == want
        np.testing.assert_array_equal(r["cases"]["prescale"], _rows(single["prescale"], r))


@pytest.mark.parametrize("case", ["c_sumcheck_product", "c_acc_product_and_share"])
def test_field_primitive(ranks, single, jax_ref, case):
    """Field values bit for bit against both single-process runs."""
    want_port, want_jax = single[case], jax_ref[case]
    if case == "c_sumcheck_product":
        want_port, want_jax = [want_port], [want_jax]
    for got_p, got_j in zip(want_port, want_jax):
        np.testing.assert_array_equal(_limbs(got_p), _limbs(got_j))
    for r in ranks:
        got = r["cases"][case]
        got = [got] if case == "c_sumcheck_product" else got
        for g, w in zip(got, want_port):
            np.testing.assert_array_equal(g, _rows(w, r))
        assert r["cases"][f"{case}_counters"] == single[f"{case}_counters"]
    assert single[f"{case}_counters"] == jax_ref[f"{case}_counters"]


def test_d_msm(ranks, single, jax_ref):
    """Points by affine value against both single-process runs."""
    want = _affine(single["d_msm"])
    assert _affine(jax_ref["d_msm"]) == want
    for r in ranks:
        assert _affine(r["cases"]["d_msm"]) == want[r["offset"]:r["offset"] + r["local"]]
        assert r["cases"]["d_msm_counters"] == single["d_msm_counters"]
    assert single["d_msm_counters"] == jax_ref["d_msm_counters"]


def test_shard_parameters(ranks):
    """Rows by field name at (4, 1): the cut inputs equal the whole
    inputs' rows and those drawn for the rank alone; the others (the
    challenges among them) stay whole; a per-party packed level gives the
    same base through either, and an SRS file loaded for the rank holds
    the same rows."""
    for r in ranks:
        s = r["shard"]
        for name, whole in s["whole"].items():
            want = _rows(whole, r) if name in PARTY_FIELDS else whole
            np.testing.assert_array_equal(s["cut"][name], want, err_msg=name)
            np.testing.assert_array_equal(s["drawn"][name], want, err_msg=name)
        assert s["packed_offset"] == s["loaded_offset"] == r["offset"]
        for got, want in zip(s["loaded"], s["cut_levels"]):  # rows cut on the host
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(s["loaded_root"][0], s["loaded"][0][0])
        for a, b in zip(s["base_cut"], s["base_whole"]):
            np.testing.assert_array_equal(a, b)
        assert s["base_cut"][0].shape[0] == P


def test_no_fallback():
    """An unknown backend raises, and a leader net joins no group (NCCL
    without a card: tests/test_torch_package.py)."""
    with pytest.raises(ValueError, match="backend"):
        sharding.init_party_group("mpi", 2, 0, "file:///nonexistent")
    with pytest.raises(ValueError, match="sim"):
        PartyNet(8, "leader", group=object())
