"""State carried between the JAX package and the port, as numpy.

The port never imports the JAX package; callers that hold both (the
tests) hand its arrays and host matrices across as numpy with these.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves.g1 import PointJ
from .device import DEFAULT, resolve
from .pss.pss import PackedSharingParams


def from_numpy(arr_u32: np.ndarray, device=DEFAULT) -> torch.Tensor:
    """``uint32 [..., L]`` limb array -> ``int32`` tensor with the same bits,
    on ``device`` (raises if CUDA is asked for and absent)."""
    dev = resolve(device)
    arr = np.ascontiguousarray(arr_u32)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected a uint32 limb array, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``int32`` limb tensor -> ``uint32`` ndarray with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 limb tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def points_from_numpy(pt, device=DEFAULT) -> PointJ:
    """Three ``uint32 [..., 24]`` coordinate arrays (such as a JAX
    ``PointJ`` of SRS bases, as numpy) -> ``PointJ`` on ``device``."""
    return PointJ(*(from_numpy(np.asarray(a), device) for a in pt))


def points_to_numpy(pt) -> tuple:
    """``PointJ`` -> (x, y, z) ``uint32`` ndarrays with the same bits."""
    return tuple(to_numpy(a) for a in pt)


def pss_matrices(pp: PackedSharingParams) -> dict[str, np.ndarray]:
    """The port's host maps as object-int arrays, keyed by method name."""
    return {
        "pack_matrix": pp.pack_matrix(),
        "unpack_matrix": pp.unpack_matrix(),
        "unpack2_matrix": pp.unpack2_matrix(),
        "pack_single_vector": pp.pack_single_vector(),
        "pack_single_reconstructible_vector": pp.pack_single_reconstructible_vector(),
    }


def check_pss_matrices(pp: PackedSharingParams, other: dict[str, np.ndarray]):
    """Raise ``ValueError`` unless every map in ``other`` (the same keys as
    :func:`pss_matrices`, e.g. from the JAX package's object) equals the
    port's entry for entry."""
    mine = pss_matrices(pp)
    if set(other) != set(mine):
        raise ValueError(f"keys differ: {sorted(other)} vs {sorted(mine)}")
    for name, mat in mine.items():
        theirs = np.asarray(other[name], dtype=object)
        if theirs.shape != mat.shape or any(
            int(a) != int(b) for a, b in zip(theirs.reshape(-1), mat.reshape(-1))
        ):
            raise ValueError(f"PSS {name} differs from the port's")
