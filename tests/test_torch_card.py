"""The elementwise kernel on operands read through their strides, the G1
kernels (also the team kernels at the prove's shapes), the dense MSM, the
strided Fr products, the int8 engine and the fold-phase kernel on the
card, against the plain versions; the honest SRS built on the card against
the CPU build, the port's sim-mode bundle proved there against the
verifier, and the dry run of the parties spread over two ranks.  Every test here needs a CUDA card and
skips without one; the file imports nothing of JAX, so it also runs where
JAX is not installed (``tests/conftest.py`` imports it, hence
``--noconftest``):

    python -m pytest --noconftest tests/test_torch_card.py tests/test_torch_package.py -m gpu
"""

import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.fields import cuda_fr, mxu
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1, map_points
from scalable_collaborative_zksnark_tpu_torch.primitives import cuda_sumcheck, msm, mxu_sumcheck
from scalable_collaborative_zksnark_tpu_torch.scripts import exp_fieldmul
from scalable_collaborative_zksnark_tpu_torch.utils.digest import point_digest


@pytest.fixture()
def cuda():
    """The card, or a skip; decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_g1_kernels_match_plain_on_card(cuda):
    """Each G1 kernel bit for bit against its plain version, on points
    with Z != 1 and an equal pair, a cancelling pair and infinities (the
    masked ops with a mask of 0s and 1s)."""
    C = bls12_381_g1(cuda)
    spec = C.fq.spec
    P = C.double(chip_smoke.rand_points_flat(C, 32, 1))
    Q = C.double(chip_smoke.rand_points_flat(C, 32, 2))
    p1, p2 = chip_smoke._edge_points(C, P, Q)
    grid = map_points(lambda a: a[:36].reshape(6, 6, -1), p1)
    mask = torch.arange(p1.x.shape[0], device=cuda) % 3 != 1
    for name, args in (("add", (p1, p2)), ("add_mixed", (p1, C.normalize(p2))), ("double", (p1,)),
                       ("scalar_mul", (p1, C.fr.random((p1.x.shape[0],), 5))),
                       ("horner", (grid, 4)), ("bucket_serial", (grid,)),
                       ("add_masked", (p1, C.normalize(p2), mask)),
                       ("add_reset", (p1, C.normalize(p2), mask))):
        kern = getattr(cuda_g1, name)
        for a, b in zip(kern(spec, *args), kern.plain(spec, *args), strict=True):
            assert torch.equal(a, b), name


@pytest.mark.gpu
def test_chain_kernels_match_plain_on_card(cuda):
    """csrc/g1_chain.cu at the prove's shapes: bucket-serial at K = 33 on
    192 and 1,677 lanes (4 segments) and Horner at W 32, C 3, c 8, bit for
    bit against their plain versions, one launch each; the low-latency
    product against Fq ``mul`` (fmul) on random values and on 0, 1, p - 1,
    R mod p."""
    C = bls12_381_g1(cuda)
    spec, Fq = C.fq.spec, C.fq
    for M in (192, 1677):
        bk = map_points(lambda a: a.reshape(33, M, -1), chip_smoke.rand_points_flat(C, 33 * M, M))
        before = cuda_g1.bucket_serial.launches
        out = cuda_g1.bucket_serial(spec, bk)
        assert cuda_g1.bucket_serial.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(out, cuda_g1.bucket_serial.plain(spec, bk)))
    assert cuda_g1.bucket_segments(33, 1677) == 4
    tot = map_points(lambda a: a.reshape(32, 3, -1), chip_smoke.rand_points_flat(C, 96, 7))
    before = cuda_g1.horner.launches
    out = cuda_g1.horner(spec, tot, 8)
    assert cuda_g1.horner.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(out, cuda_g1.horner.plain(spec, tot, 8)))
    edge = Fq.array_from_ints([0, 1, Fq.p - 1, Fq.spec.r % Fq.p])
    a = torch.cat([Fq.random((4096,), 8), edge.repeat_interleave(4, dim=0)])
    b = torch.cat([Fq.random((4096,), 9), edge.repeat(4, 1)])
    assert torch.equal(cuda_g1.fq_mul_cc(spec, a, b), cuda_fr.mul(spec, a, b))


@pytest.mark.gpu
def test_team_kernels_match_plain_on_card(cuda):
    """Point add (a team of 4 lanes a point) at 3, 96 and 8,192 lanes, with
    the six edge lanes at 3 and 8,192, and the accumulate (a team of 2
    lanes a scan lane) on ``chip_smoke.accumulate_cases``: a forced
    x-collision, a warp whose teams diverge (resets, adds, cancels,
    padding and doublings at one step) and random keys over two staging
    chunks; bit for bit against their plain versions, one launch a call."""
    C = bls12_381_g1(cuda)
    spec = C.fq.spec
    held = chip_smoke.check_add_lanes(C, (3, 96, 8192))  # checks one launch a call
    assert held == [3, 96, 8192, "3 with edge lanes", "3 with edge lanes",
                    "8192 with edge lanes"]
    for name, args in chip_smoke.accumulate_cases(C):
        before = cuda_g1.accumulate.launches
        out, doubled = cuda_g1.accumulate(spec, *args)
        assert cuda_g1.accumulate.launches == before + 1
        want, want_doubled = cuda_g1.accumulate.plain(spec, *args)
        assert doubled == want_doubled > 0, name
        assert all(torch.equal(a, b) for a, b in zip(out, want, strict=True)), name


@pytest.mark.gpu
def test_ladder_and_masked_teams_match_plain_on_card(cuda):
    """The ladder (a team of 4 lanes a lane, 4-bit windows) on
    ``chip_smoke.ladder_cases`` (a warp whose teams diverge, 2-limb
    scalars) and the masked adds (a team of 2 lanes a point) on
    ``chip_smoke.masked_cases`` over 4,096 points and the edge lanes; bit
    for bit against their plain versions, one launch a call."""
    C = bls12_381_g1(cuda)
    spec = C.fq.spec
    calls = [("scalar_mul", args) for _, args in chip_smoke.ladder_cases(C)]
    for _, args in chip_smoke.masked_cases(C, 4096):
        calls += [("add_masked", args), ("add_reset", args)]
    for name, args in calls:
        kern = getattr(cuda_g1, name)
        before = kern.launches
        out = kern(spec, *args)
        assert kern.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(out, kern.plain(spec, *args), strict=True))


@pytest.mark.gpu
def test_msm_on_card_matches_cpu(cuda):
    """The dense MSM through the kernels and through the plain versions on
    the CPU give the same normalized points."""
    T = bls12_381_g1("cpu")
    C = bls12_381_g1(cuda)
    bases = chip_smoke.rand_points_flat(C, 300, 3)
    sc = C.fr.decode(C.fr.random((3, 300), 4))
    on_card = msm.msm(C, bases, sc)
    on_cpu = msm.msm(T, PointJ(*(a.cpu() for a in bases)), sc.cpu())
    assert point_digest(C, on_card) == point_digest(T, on_cpu)


@pytest.mark.gpu
def test_strided_products_match_plain_on_card(cuda):
    """The limb-major and tiled Fr products bit for bit against their plain
    versions and, back in the element-major layout, against Fr ``mul``
    (the first lanes 0, 1, p - 1, R mod p); one launch each; a bad shape
    is refused before any launch."""
    F = get_field("bls12_381_fr", device=cuda)
    a, b = F.random((8192,), 1), F.random((8192,), 2)
    a[:4] = F.array_from_ints([0, 1, F.p - 1, F.spec.r % F.p])
    ref = F.mul(a, b)
    for kern, to, back in ((cuda_fr.mul_limb_major, exp_fieldmul.to_limb_major,
                            exp_fieldmul.from_limb_major),
                           (cuda_fr.mul_tiled, exp_fieldmul.to_tiled, exp_fieldmul.from_tiled)):
        before = kern.launches
        out = kern(F.spec, to(a), to(b))
        assert kern.launches == before + 1
        assert torch.equal(out, getattr(cuda_fr, f"{kern.__name__}_plain")(F.spec, to(a), to(b)))
        assert torch.equal(back(out), ref)
    before = cuda_fr.mul_limb_major.launches
    with pytest.raises(ValueError):
        cuda_fr.mul_limb_major(F.spec, a[:1000].T.contiguous(), a[:1000].T.contiguous())
    assert cuda_fr.mul_limb_major.launches == before


@pytest.mark.gpu
def test_int8_engine_on_card_matches_cpu(cuda):
    """The int8 product phase and dot_red through ``torch._int_mm`` on the
    card equal the same calls on the CPU, and the phase equals the
    fold-phase kernel."""
    Fc, Fh = get_field("bls12_381_fr", device=cuda), get_field("bls12_381_fr", device="cpu")
    f, g, ch = Fh.random((3, 64), 1), Fh.random((3, 64), 2), Fh.random((8,), 3)
    on_card = mxu_sumcheck.product_phase(Fc, f.to(cuda), g.to(cuda), ch.to(cuda), 1)
    on_cpu = mxu_sumcheck.product_phase(Fh, f, g, ch, 1)
    kernel = cuda_sumcheck.product_phase(Fc, f.to(cuda), g.to(cuda), ch.to(cuda), 1)
    for a, b, c in zip(on_card[0] + list(on_card[1:]), on_cpu[0] + list(on_cpu[1:]),
                       kernel[0] + list(kernel[1:])):
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)
    x, y = Fh.random((5, 37), 4), Fh.random((5, 37), 5)
    got = mxu.dot_red(Fc.spec, mxu.to_red(x.to(cuda)), mxu.to_red(y.to(cuda)))
    want = mxu.dot_red(Fh.spec, mxu.to_red(x), mxu.to_red(y))
    assert got.bound == want.bound and torch.equal(got.arr.cpu(), want.arr)


@pytest.mark.gpu
def test_phase_kernel_matches_plain_on_card(cuda):
    """The fold-phase kernel at every table shape the (16, 8) prove folds,
    M = 2 and 4, every cluster size, head rounds before the cluster and
    [1, 2^21], on tables and challenges holding 0, 1 and p - 1, bit for
    bit against its plain version (``chip_smoke.check_phase``), one launch
    a phase up to 2^13; the carry-chain Fr product against fmul<8>."""
    F = get_field("bls12_381_fr", device=cuda)
    err, held = chip_smoke.check_phase(F)
    assert err == 0 and len(held) == len(chip_smoke.PHASE_CHECKS)
    assert {K for _, _, K, _ in held} == {1, 2, 4, 8}
    assert all((head == 0) == (M <= cuda_sumcheck.TAIL_MAX) for _, M, _, head in held)
    assert chip_smoke.fr_chain(F)["fr_mul_cc_held_on"] == (1 << 16) + 16


@pytest.mark.gpu
@pytest.mark.parametrize("field", ["bls12_381_fr", "bls12_381_fq"])
def test_binary_cases_match_plain_on_card(cuda, field):
    """The elementwise kernel on ``chip_smoke.binary_cases`` (edge values,
    a transposed view, a stepped slice, middle broadcasts, the outer
    product [64, 1] x [1, 256], a misaligned base, a staged launch's
    partial tile), through the wrappers and in small and staged launches,
    bit for bit against the plain versions, no operand copied; one launch
    a wrapper call; then ``add_mixed`` and ``double`` (the point-op team
    kernel) on the edge lanes, one launch each."""
    F = get_field(field, device=cuda)
    cases = chip_smoke.binary_cases(F)
    before = cuda_fr.mul.launches
    assert chip_smoke.check_binary_cases(F, cases) == list(cases)
    assert cuda_fr.mul.launches == before + len(cases)
    if field == "bls12_381_fq":
        C = bls12_381_g1(cuda)
        P = C.double(chip_smoke.rand_points_flat(C, 58, 11))
        Q = C.double(chip_smoke.rand_points_flat(C, 58, 12))
        p1, p2 = chip_smoke._edge_points(C, P, Q)
        for name, args in (("add_mixed", (p1, C.normalize(p2))), ("double", (p1,))):
            kern = getattr(cuda_g1, name)
            before = kern.launches
            out = kern(C.fq.spec, *args)
            assert kern.launches == before + 1
            assert all(torch.equal(a, b) for a, b in zip(out, kern.plain(C.fq.spec, *args),
                                                         strict=True)), name


def _secrets(n_vars: int, seed: int) -> list:
    return chip_smoke._secrets(n_vars, seed)


@pytest.mark.gpu
def test_sim_bundle_verifies_on_card(cuda):
    """The port's own sim-mode (4, 1) ``dhyperplonk`` bundle, proved on the
    card from consistent shares and honest SRSs built there, passes the
    complete verifier with its pairings."""
    from scalable_collaborative_zksnark_tpu_torch.curves import host_curve as hc
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk import dhyperplonk
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import (
        consistent_proving_parameters)
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk.verify import verify_dhyperplonk
    from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk.collaborative import eq_top_table
    from scalable_collaborative_zksnark_tpu_torch.primitives.poly_comm import srs_from_secret
    from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams

    C = bls12_381_g1(cuda)
    n, l = 4, 1
    net = PartyNet(8 * l, mode="sim")
    pp = PackedSharingParams(C.fr, l)
    d = srs_from_secret(C, hc.G1_GEN, hc.G2_GEN, _secrets(n + 2, 31), n_parties=net.n)
    c_srs = srs_from_secret(C, hc.G1_GEN, hc.G2_GEN, _secrets(n + 2, 37), pp=pp)
    pk, g = consistent_proving_parameters(n, l, net, {"c": c_srs, "d": d}, curve=C)
    proof = dhyperplonk(n, pk, net, c=4)
    assert verify_dhyperplonk(pp, c_srs, d, proof, g, pk.challenge, pk.challenge_r2,
                              eq_top_table(C.fr, net.n)) == (True, [])


@pytest.mark.gpu
def test_srs_on_card_matches_cpu(cuda):
    """The honest SRS at 8 variables with 8 parties, and its packing for
    l = 1, built on the card equal the same built through the plain
    versions on the CPU, point for point in affine limbs."""
    from scalable_collaborative_zksnark_tpu_torch.curves import host_curve as hc
    from scalable_collaborative_zksnark_tpu_torch.primitives.poly_comm import srs_from_secret
    from scalable_collaborative_zksnark_tpu_torch.pss.pss import PackedSharingParams

    s = _secrets(8, 17)
    built = {}
    for dev in (cuda, torch.device("cpu")):
        C = bls12_381_g1(dev)
        srs = srs_from_secret(C, hc.G1_GEN, hc.G2_GEN, s, n_parties=8,
                              pp=PackedSharingParams(C.fr, 1))
        levels = (srs.powers_of_g + [lv for k in sorted(srs.root_levels)
                                     for lv in srs.root_levels[k]] + srs.packed_powers)
        built[dev.type] = [torch.stack(tuple(pt)).cpu() for pt in levels]
    assert len(built["cuda"]) == len(built["cpu"])
    for a, b in zip(built["cuda"], built["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_sharding_dryrun_on_cards(cuda):
    """``sharding.dryrun`` with 2 ranks: NCCL, one a card, where two cards
    are visible, else two gloo ranks sharing the card.  Each prover's
    gathered bundle and every rank's comm equal the single-process sim
    run's at the dry run's sizes."""
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk import sharding
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk.collaborative import (
        cpermcheck, dhyperplonk, dhyperplonk_data_parallel, dpermcheck)
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import (
        packed_proving_parameters)
    from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
    from scalable_collaborative_zksnark_tpu_torch.utils.digest import proof_digest

    two = torch.cuda.device_count() >= 2
    reports = sharding.dryrun(2, "nccl" if two else "gloo", "cuda" if two else "cuda:0",
                              timeout=600)
    n, l = sharding.dryrun_sizes(2)
    net = PartyNet(8 * l, "sim")
    pk = packed_proving_parameters(n, l, net, device=cuda)
    for fn in (dhyperplonk, dhyperplonk_data_parallel, dpermcheck, cpermcheck):
        net.reset_comm()
        digest = f"0x{proof_digest(pk.curve, fn(n, pk, net)):016x}"
        for rep in reports:
            assert rep[fn.__name__]["digest"] == digest, fn.__name__
            assert rep[fn.__name__]["comm"] == list(net.comm(0)), fn.__name__
