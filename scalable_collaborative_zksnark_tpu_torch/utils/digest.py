"""Digests of limb arrays, for pinning results across packages and devices.

sha256 over the little-endian ``uint32`` bytes of a C-ordered limb array.
The JAX package's ``uint32`` arrays and the port's ``int32`` tensors hold
the same bits, so a digest made from either matches the other.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _limb_bytes(arr) -> bytes:
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(arr).view(np.uint32), dtype="<u4").tobytes()


def limb_digest(arr) -> str:
    """Hex sha256 of ``arr`` (numpy array, or a tensor on any device)."""
    return hashlib.sha256(_limb_bytes(arr)).hexdigest()


def point_digest(curve, pt) -> str:
    """Hex sha256 of the x, y and z limbs of ``curve.normalize(pt)``, one
    after the other.  Normalized points are canonical (affine, infinity
    (0, 1, 0)), so backends that return different Jacobian representatives
    of the same points digest alike; ``curve`` may be either package's."""
    h = hashlib.sha256()
    for a in curve.normalize(pt):
        h.update(_limb_bytes(a))
    return h.hexdigest()
