"""Digests of limb arrays and proof bundles, for pinning results across
packages and devices.

``limb_digest`` / ``point_digest``: sha256 over the little-endian
``uint32`` bytes of a C-ordered limb array.  The JAX package's ``uint32``
arrays and the port's ``int32`` tensors hold the same bits, so a digest
made from either matches the other.

``proof_digest``: the JAX package's 64-bit bundle digest
(``utils/benchlib.py`` ``proof_digest``), in numpy: points normalized to
affine (infinity (0, 1, 0)), leaves in ``jax.tree.leaves`` order (tuples
and lists in order, a point as x, y, z), each leaf summed as
sum(x_i * ((i mod 8191) + 1)) mod 2^32 over its uint32 words, the sums
folded as d = d * 1000003 + leaf mod 2^64.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..curves.g1 import PointJ


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


def canonical_points(curve, pt: PointJ) -> tuple:
    """(x, y, z) ``uint32`` arrays of ``pt`` normalized on the host: affine
    (x, y, 1) or infinity (0, 1, 0), Montgomery limbs of the port's
    ``curve`` (``Curve.normalize``'s values, without launching a kernel)."""
    Fq = curve.fq
    shape = tuple(pt.x.shape[:-1])
    to_limbs = lambda v: Fq.to_mont_int(v).astype(np.uint32)  # noqa: E731
    zero, one = to_limbs(0), to_limbs(1)
    rows = [(zero, one, zero) if a is None else (to_limbs(a[0]), to_limbs(a[1]), one)
            for a in curve.to_affine_ints(pt)]
    return tuple(np.stack([r[j] for r in rows]).reshape(shape + (Fq.L,)) if rows
                 else np.zeros(shape + (Fq.L,), np.uint32) for j in range(3))


def canonicalize_proof(curve, out):
    """The bundle with every ``PointJ`` replaced by its canonical (x, y, z)
    and every tensor by a ``uint32`` numpy array, tuples and lists kept."""
    if isinstance(out, PointJ):
        return canonical_points(curve, out)
    if isinstance(out, (tuple, list)):
        return type(out)(canonicalize_proof(curve, x) for x in out)
    return np.asarray(out.detach().cpu().numpy() if hasattr(out, "detach") else out).view(
        np.uint32)


def _leaves(out):
    if isinstance(out, (tuple, list)):
        for x in out:
            yield from _leaves(x)
    else:
        yield out


def leaf_sum(a: np.ndarray) -> int:
    """sum(x_i * ((i mod 8191) + 1)) mod 2^32 over the uint32 words of ``a``."""
    x = np.ascontiguousarray(a).view(np.uint32).reshape(-1).astype(np.uint64)
    w = np.arange(x.size, dtype=np.uint64) % 8191 + 1
    return int(np.sum(x * w, dtype=np.uint64)) & 0xFFFFFFFF


def proof_digest(curve, out) -> int:
    """Order-sensitive 64-bit digest of a proof bundle, equal to the JAX
    package's ``proof_digest`` of the same values: a pin certifies values,
    not the Jacobian representatives an MSM backend returns."""
    d = 0
    for leaf in _leaves(canonicalize_proof(curve, out)):
        d = (d * 1000003 + leaf_sum(leaf)) % (1 << 64)
    return d
