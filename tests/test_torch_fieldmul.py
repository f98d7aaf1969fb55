"""Port parity: the Fr product in the layouts of ``scripts/exp_fieldmul.py``.

The plain versions of the limb-major and tiled kernels (the script's
16-bit CIOS, limb by limb on ``int64``), and the wrappers on CPU tensors,
against the JAX package's ``Field.mul`` on the script's inputs
(``F.random`` seeds 1 and 2), bit for bit; the wrappers' shape checks; the
port's ``exp_fieldmul.run`` on the CPU; and (slow) the recomputation of
``chip_smoke.py``'s 2^20 product pin from the JAX package.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from scalable_collaborative_zksnark_tpu.fields.fr import get_field as jax_field
from scalable_collaborative_zksnark_tpu_torch import convert
from scalable_collaborative_zksnark_tpu_torch.fields import cuda_fr
from scalable_collaborative_zksnark_tpu_torch.fields.fr import get_field
from scalable_collaborative_zksnark_tpu_torch.scripts import exp_fieldmul
from scalable_collaborative_zksnark_tpu_torch.utils.digest import limb_digest

NAME = "bls12_381_fr"


@functools.lru_cache(maxsize=None)
def _jax_product(M):
    """The script's inputs and the JAX package's Field.mul of them (numpy)."""
    JF = jax_field(NAME)
    a, b = JF.random((M,), 1), JF.random((M,), 2)
    return np.asarray(a), np.asarray(b), np.asarray(JF.mul(a, b))


@pytest.mark.parametrize("M", [4096, 8192])
@pytest.mark.parametrize("layout", ["limb_major", "tiled"])
def test_layouts_match_jax_mul(M, layout):
    """Plain version and CPU wrapper in the layout, and the element-major
    CIOS, equal the JAX package's product."""
    spec = get_field(NAME, device="cpu").spec
    a, b, want = _jax_product(M)
    ta, tb = convert.from_numpy(a, "cpu"), convert.from_numpy(b, "cpu")
    to = getattr(exp_fieldmul, f"to_{layout}")
    back = getattr(exp_fieldmul, f"from_{layout}")
    plain = getattr(cuda_fr, f"mul_{layout}_plain")
    wrapper = getattr(cuda_fr, f"mul_{layout}")
    for out in (plain(spec, to(ta), to(tb)), wrapper(spec, to(ta), to(tb))):
        np.testing.assert_array_equal(convert.to_numpy(back(out).contiguous()), want)
    np.testing.assert_array_equal(convert.to_numpy(cuda_fr.mul_cios16_plain(spec, ta, tb)), want)


def test_layout_transforms():
    """Tile g holds elements g*4096 .. g*4096 + 4095, element s*512 + l at
    [g, :, s, l]; limb-major is the transpose; both invert."""
    x = torch.arange(8192 * 16, dtype=torch.int32).reshape(8192, 16)
    t = exp_fieldmul.to_tiled(x)
    assert tuple(t.shape) == (2, 16, 8, 512)
    assert torch.equal(t[1, :, 3, 7], x[4096 + 3 * 512 + 7])
    assert torch.equal(exp_fieldmul.from_tiled(t), x)
    assert torch.equal(exp_fieldmul.to_limb_major(x)[:, 5], x[5])
    assert torch.equal(exp_fieldmul.from_limb_major(exp_fieldmul.to_limb_major(x)), x)


def test_shape_errors():
    """The wrappers refuse what the kernels would not take: M not a
    multiple of 1,024 (limb-major) or a tile shape other than (16, 8, 512),
    operands of two shapes, a field that is not 16-limb; and a tensor that
    is neither on the CPU nor on the card."""
    F = get_field(NAME, device="cpu")
    z = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    bad = [(cuda_fr.mul_limb_major, z(16, 1000)), (cuda_fr.mul_limb_major, z(16, 0)),
           (cuda_fr.mul_limb_major, z(24, 1024)), (cuda_fr.mul_limb_major, z(1024, 16)),
           (cuda_fr.mul_tiled, z(1, 16, 8, 256)), (cuda_fr.mul_tiled, z(1, 16, 4096)),
           (cuda_fr.mul_tiled, z(0, 16, 8, 512))]
    for kern, x in bad:
        with pytest.raises(ValueError, match=kern.__name__):
            kern(F.spec, x, x)
    with pytest.raises(ValueError, match="differ"):
        cuda_fr.mul_limb_major(F.spec, z(16, 1024), z(16, 2048))
    Fq = get_field("bls12_381_fq", device="cpu")
    with pytest.raises(ValueError, match="16-limb"):
        cuda_fr.mul_limb_major(Fq.spec, z(16, 1024), z(16, 1024))
    meta = torch.zeros((16, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):
        cuda_fr.mul_limb_major(F.spec, meta, meta)
    with pytest.raises(ValueError, match="2\\^m"):
        exp_fieldmul.run(11, "cpu")


def test_exp_fieldmul_run_on_cpu(capsys):
    """The script at 2^12 on the CPU: four formulations, each printed with
    ``match``, A's product equal to the JAX package's."""
    rows = exp_fieldmul.run(12, "cpu", reps=1)
    assert [r["name"] for r in rows] == ["A", "B", "C", "D"]
    assert all(r["match"] for r in rows)
    assert rows[0]["digest"] == limb_digest(_jax_product(4096)[2])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(line.split()[-1] == "match" or "match  (kernel" in line
                                 for line in out)


@pytest.mark.slow
def test_chip_smoke_fieldmul_pin():
    """chip_smoke.py's exp_fieldmul pin is the JAX package's Field.mul of
    the script's 2^20 inputs (this is how it was made)."""
    assert limb_digest(_jax_product(1 << 20)[2]) == chip_smoke.PINS["exp_fieldmul"]
