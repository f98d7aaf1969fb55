"""The G1 kernels and the dense MSM on the card, against the plain
versions.  Every test here needs a CUDA card and skips without one; the
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_card.py tests/test_torch_package.py -m gpu
"""

import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.curves.g1 import PointJ, bls12_381_g1, map_points
from scalable_collaborative_zksnark_tpu_torch.primitives import msm
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
