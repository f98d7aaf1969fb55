"""The G1 kernels, the dense MSM, the strided Fr products and the int8
engine on the card, against the plain versions.  Every test here needs a CUDA card and skips without one; the
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_card.py tests/test_torch_package.py -m gpu
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
