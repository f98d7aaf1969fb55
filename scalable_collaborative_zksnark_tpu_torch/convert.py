"""State carried between the JAX package and the port, as numpy.

The port never imports the JAX package; callers that hold both (the
tests) hand its arrays and host matrices across as numpy with these.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .curves.g1 import PointJ, bls12_381_g1
from .device import DEFAULT, resolve
from .hyperplonk.local import LocalInputs
from .hyperplonk.params import PackedProvingParameters, map_levels, srs_from_host
from .hyperplonk.sharding import shard_parameters
from .pss.pss import PackedSharingParams


def _host_limbs(arr_u32) -> np.ndarray:
    """``uint32 [..., L]`` limb array -> a new ``int32`` array, same bits."""
    arr = np.ascontiguousarray(arr_u32)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected a uint32 limb array, got {arr.dtype}")
    return arr.view(np.int32).copy()


def from_numpy(arr_u32: np.ndarray, device=DEFAULT) -> torch.Tensor:
    """``uint32 [..., L]`` limb array -> ``int32`` tensor with the same bits,
    on ``device`` (raises if CUDA is asked for and absent)."""
    dev = resolve(device)
    return torch.from_numpy(_host_limbs(arr_u32)).to(dev)


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


def _is_point(x) -> bool:
    """Three limb arrays of one shape whose last axis holds an Fq element
    (24 limbs): a point's (x, y, z), as a tuple or either package's
    ``PointJ``.  Fr values have 16 limbs, so no bundle field is mistaken."""
    if not isinstance(x, tuple) or len(x) != 3:
        return False
    if any(isinstance(a, (tuple, list)) or not hasattr(a, "shape") for a in x):
        return False
    return all(a.shape == x[0].shape for a in x) and x[0].shape[-1:] == (24,)


def bundle_from_numpy(bundle, device=DEFAULT):
    """A proof bundle of either package (nested tuples and lists of
    ``uint32`` limb arrays and (x, y, z) points, such as the JAX package's
    bundle with its arrays, or ``np.asarray`` of them) -> the same structure
    of the port's tensors and ``PointJ``s on ``device``."""
    if _is_point(bundle):
        return points_from_numpy(bundle, device)
    if isinstance(bundle, (tuple, list)):
        return type(bundle)(bundle_from_numpy(x, device) for x in bundle)
    return from_numpy(np.asarray(bundle), device)


def local_inputs_from_numpy(ins, device=DEFAULT) -> LocalInputs:
    """The JAX package's ``LocalInputs`` (limb fields as ``uint32`` arrays,
    or anything ``np.asarray`` takes) -> the port's, on ``device``."""
    fields = {f.name: getattr(ins, f.name) for f in dataclasses.fields(LocalInputs)}
    return LocalInputs(**{k: int(v) if k == "n" else from_numpy(np.asarray(v), device)
                          for k, v in fields.items()})


def _srs_host(srs) -> dict:
    """The JAX package's SRS (point levels as three ``uint32`` arrays each,
    or anything ``np.asarray`` takes) -> the port's host fields of it
    (``params.srs_to_host``'s form)."""
    limbs = lambda levels: map_levels(  # noqa: E731
        levels, lambda pt: tuple(_host_limbs(np.asarray(a)) for a in pt))
    return {"powers_of_g": limbs(srs.powers_of_g), "powers_of_g2": list(srs.powers_of_g2),
            "party_weights": srs.party_weights, "root_levels": limbs(srs.root_levels),
            "packed_powers": limbs(srs.packed_powers), "affine": bool(srs.affine),
            "packed_offset": 0}


def srs_from_numpy(curve, srs):
    """The JAX package's ``PolynomialCommitment`` (host G2 points and party
    weights as they are) -> the port's on ``curve``'s device."""
    return srs_from_host(curve, _srs_host(srs))


_SRS_FIELDS = ("c_commitment", "d_commitment")


def proving_parameters_from_numpy(pk, device=DEFAULT, net=None):
    """The JAX package's ``PackedProvingParameters`` (each limb field a
    ``uint32`` array, or anything ``np.asarray`` takes) -> the port's, on
    ``device``: the same inputs for both provers, so a mismatch names its
    step.  The curve is BLS12-381's G1.  With a ``net`` spread over
    processes, the inputs keep the net's rows, cut on the host before the
    upload (``sharding.shard_parameters``)."""
    curve = bls12_381_g1(device)
    host = {f.name: getattr(pk, f.name) for f in dataclasses.fields(PackedProvingParameters)
            if f.name not in ("n", "pp", "curve")}
    host = {k: _srs_host(v) if k in _SRS_FIELDS else np.asarray(v) for k, v in host.items()}
    if net is not None:
        host = shard_parameters(host, net)
    fields = {k: srs_from_host(curve, v) if k in _SRS_FIELDS else from_numpy(v, device)
              for k, v in host.items()}
    return PackedProvingParameters(n=int(pk.n), pp=PackedSharingParams(curve.fr, int(pk.pp.l)),
                                   curve=curve, **fields)


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
