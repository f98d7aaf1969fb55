"""The elementwise kernel's operands, read in place through their strides.

``cuda_fr.kernel_operands`` turns each operand of a launch into its base
pointer and its int32-slot strides along the output's coalesced batch
dims, as ``csrc/fr.cu`` reads it.  Here each operand is gathered back
through that pointer and those strides (``torch.as_strided`` on its
storage) and must equal ``torch.broadcast_to`` of the operand exactly;
``cuda_fr.copies`` counts the operands materialised instead, 0 for every
case within ``MAX_RANK`` coalesced dims.  CPU only: the kernel itself runs
on the host emulation in ``test_torch_csrc.py`` and on the card in
``test_torch_card.py``.
"""

import numpy as np
import pytest
import torch

from scalable_collaborative_zksnark_tpu_torch.fields import cuda_fr

L = 16


def _base(*shape, seed=0):
    n = int(np.prod(shape))
    vals = np.random.RandomState(seed).randint(0, 1 << 16, size=n).astype(np.int32)
    return torch.from_numpy(vals).reshape(shape)


def _misaligned(*shape):
    """A contiguous operand whose base is 4 bytes past a 16-byte boundary."""
    flat = _base(int(np.prod(shape)) + 4, seed=3)
    off = next(k for k in range(4) if (flat.data_ptr() + 4 * k) % 16 == 4)
    x = flat[off:off + int(np.prod(shape))].view(shape)
    assert x.data_ptr() % 16 == 4
    return x


# name: (a, b, coalesced dims the launch keeps)
CASES = {
    "contiguous": (lambda: _base(6, L), lambda: _base(6, L, seed=1), 1),
    "constant_0d": (lambda: _base(6, L), lambda: _base(L, seed=1), 1),
    "constant_both": (lambda: _base(1, 1, L), lambda: _base(L, seed=1), 1),
    "transposed": (lambda: _base(5, 7, L).transpose(0, 1), lambda: _base(7, 5, L, seed=1), 2),
    "stepped": (lambda: _base(20, L)[::3], lambda: _base(7, L, seed=1), 1),
    "stepped_inner": (lambda: _base(4, 9, L)[:, 1::2], lambda: _base(4, 1, L, seed=1), 2),
    "trailing_block": (lambda: _base(4, 8, L), lambda: _base(8, L, seed=1), 2),
    "middle_broadcast": (lambda: _base(3, 1, L), lambda: _base(1, 5, L, seed=1), 2),
    "outer_product": (lambda: _base(64, 1, L), lambda: _base(1, 256, L, seed=1), 2),
    "misaligned": (lambda: _misaligned(6, L), lambda: _base(6, L, seed=1), 1),
    "misaligned_broadcast": (lambda: _misaligned(L), lambda: _base(2, 3, L, seed=1), 1),
    "rank1": (lambda: _base(9, L), lambda: _base(9, L, seed=1), 1),
    "rank2": (lambda: _base(3, 4, L), lambda: _base(4, 3, L, seed=1).transpose(0, 1), 2),
    "rank3": (lambda: _base(2, 3, 4, L), lambda: _base(1, 3, 1, L, seed=1), 3),
    "rank4": (lambda: _base(4, 6, 4, 6, L)[::2, :, ::2], lambda: _base(2, 1, 2, 1, L, seed=1), 4),
    "rank5_coalesced": (lambda: _base(2, 3, 2, 3, 2, L), lambda: _base(2, 3, 2, 3, 2, L, seed=1),
                        1),
    "rank5_broadcast": (lambda: _base(2, 1, 2, 1, 1, L), lambda: _base(1, 3, 1, 3, 2, L, seed=1),
                        4),
}


def _gather(x: torch.Tensor, dims: list, strides: list) -> torch.Tensor:
    """Operand ``x`` read as the kernel reads it: from its storage, at its
    data pointer, through ``strides`` (int32 slots) along ``dims``, the
    limbs contiguous."""
    flat = torch.empty(0, dtype=torch.int32).set_(x.untyped_storage())
    offset = (x.data_ptr() - flat.data_ptr()) // 4
    return torch.as_strided(flat, tuple(dims) + (L,), tuple(strides) + (1,), offset)


@pytest.mark.parametrize("name", CASES)
def test_operands_read_in_place(name):
    """Each operand gathered through its pointer and strides equals its
    broadcast, with no copy, in as many coalesced dims as the case keeps."""
    make_a, make_b, rank = CASES[name]
    a, b = make_a(), make_b()
    shape = torch.broadcast_shapes(a.shape, b.shape)
    before = cuda_fr.copies
    dims, ops = cuda_fr.kernel_operands(shape, a, b)
    assert cuda_fr.copies == before
    assert len(dims) == rank and int(np.prod(dims)) == shape.numel() // L
    for x, (y, strides) in zip((a, b), ops, strict=True):
        assert y is x  # read in place
        want = torch.broadcast_to(x, shape).reshape(tuple(dims) + (L,))
        assert torch.equal(_gather(y, dims, strides), want)


@pytest.mark.parametrize("case", ["beyond_rank", "limbs_strided"])
def test_operand_copied_and_counted(case):
    """An operand that leaves more than ``MAX_RANK`` coalesced dims (stepped
    in five dims) or whose limb axis is not unit-stride is materialised
    once and counted; the launch then reads it contiguous."""
    if case == "beyond_rank":
        a = _base(4, 4, 4, 4, 4, L)[::2, ::2, ::2, ::2, ::2]
    else:
        a = _base(L, 6).T
    b = _base(*a.shape, seed=1)
    shape = a.shape
    before = cuda_fr.copies
    dims, ((ya, sa), (yb, sb)) = cuda_fr.kernel_operands(shape, a, b)
    assert cuda_fr.copies == before + 1
    assert ya is not a and ya.is_contiguous() and yb is b and dims == [shape.numel() // L]
    assert torch.equal(_gather(ya, dims, sa), a.reshape(-1, L))
    assert torch.equal(_gather(yb, dims, sb), b.reshape(-1, L))


def test_coalesce_like_tensor_iterator():
    """Size-1 dims drop, dims merge where every operand allows, a full
    broadcast keeps one dim of stride 0."""
    assert cuda_fr.coalesce([3, 1, 4], [[64, 999, 16], [0, 5, 0]]) == ([12], [[16], [0]])
    assert cuda_fr.coalesce([3, 1, 4], [[64, 999, 16], [16, 5, 0]]) == ([3, 4],
                                                                        [[64, 16], [16, 0]])
    assert cuda_fr.coalesce([3, 4], [[64, 16], [64, 16]]) == ([12], [[16], [16]])
    assert cuda_fr.coalesce([1, 1], [[0, 7], [3, 0]]) == ([1], [[0], [0]])


@pytest.mark.parametrize("sa,sb", [((6, L), (6, L)), ((3, 1, L), (1, 5, L)), ((L,), (2, 3, L)),
                                   ((4, 1, 2, L), (3, 1, L)), ((1, L), (0, L))])
def test_broadcast_shape_as_torch(sa, sb):
    """The wrapper's broadcast shape is ``torch.broadcast_shapes``'s, and a
    pair that does not broadcast is refused."""
    assert cuda_fr.broadcast_shape(sa, sb) == tuple(torch.broadcast_shapes(sa, sb))
    with pytest.raises(ValueError):
        cuda_fr.broadcast_shape((3, L), (4, L))


MODES = {
    "contiguous": (lambda: _base(6, L), lambda: _base(6, L, seed=1), "small"),
    "transposed": (lambda: _base(5, 7, L).transpose(0, 1), lambda: _base(7, 5, L, seed=1), "small"),
    "middle_broadcast": (lambda: _base(3, 1, L), lambda: _base(1, 5, L, seed=1), "small"),
    "misaligned": (lambda: _misaligned(6, L), lambda: _base(6, L, seed=1), "staged"),
    "odd_stride": (lambda: _base(6, L + 2)[:, :L], lambda: _base(6, L, seed=1), "staged"),
    "at_stage_min": (lambda: _base(cuda_fr.STAGE_MIN, L), lambda: _misaligned(L), "staged"),
    "below_stage_min": (lambda: _base(cuda_fr.STAGE_MIN - 1, L), lambda: _base(L, seed=1), "small"),
}


@pytest.mark.parametrize("name", MODES)
def test_launch_mode(name):
    """The kernel instance a launch takes: small below ``STAGE_MIN`` outputs
    where every operand's base and strides allow 16-byte loads, else
    staged; nothing is copied to decide it."""
    make_a, make_b, mode = MODES[name]
    before = cuda_fr.copies
    assert cuda_fr.launch_mode(make_a(), make_b()) == mode
    assert cuda_fr.copies == before
