"""The comparison that decides ``correct``: a proof bundle against the
plain reference's, leaf by leaf.

Field leaves are compared limb for limb (both sides canonical Montgomery
form, so equal limbs are equal values).  A point leaf of the program (a
``PointJ`` of three base-field tensors in Montgomery form, Jacobian) is
compared as a group element with the multiple of G that the reference's
logarithm names, computed on the host.  A leaf that stands for several
elements counts each of them; a structure that differs counts every leaf
of the reference's side there as a mismatch.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import g1
from .reference.dhyperplonk_leader import Pt
from .reference.field import Fr

FQ_LIMBS = 24


def _is_point(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields") and x._fields == ("x", "y", "z")


def _count(ref) -> int:
    if isinstance(ref, Pt):
        return int(np.prod(ref.log.shape[:-1], dtype=np.int64))
    if torch.is_tensor(ref):
        return int(np.prod(ref.shape[:-1], dtype=np.int64))
    return sum(_count(r) for r in ref)


def _walk(got, want, fields, points) -> int:
    """Pairs of leaves into ``fields`` / ``points``; returns the elements
    whose structure already differs."""
    if isinstance(want, Pt):
        if isinstance(got, Pt) and got.log.shape == want.log.shape:
            fields.append((got.log, want.log))
            return 0
        if _is_point(got) and tuple(got.x.shape[:-1]) == tuple(want.log.shape[:-1]):
            points.append((got, want.log))
            return 0
        return _count(want)
    if torch.is_tensor(want):
        if torch.is_tensor(got) and tuple(got.shape) == tuple(want.shape):
            fields.append((got, want))
            return 0
        return _count(want)
    if isinstance(got, (list, tuple)) and not _is_point(got) and len(got) == len(want):
        return sum(_walk(g, w, fields, points) for g, w in zip(got, want))
    return _count(want)


def _fq_ints(t: torch.Tensor) -> list[int]:
    a = t.detach().to("cpu", torch.int64).numpy().reshape(-1, FQ_LIMBS)
    weights = [1 << (16 * i) for i in range(FQ_LIMBS)]
    return [sum(int(v) * w for v, w in zip(row, weights)) * g1.FQ_MONT_RINV % g1.Q_MOD for row in a]


def bundle_mismatches(got, want, table: g1.GeneratorTable) -> tuple[int, int]:
    """(mismatched elements, elements compared) of ``got`` against ``want``."""
    fields, points = [], []
    bad = _walk(got, want, fields, points)
    total = _count(want)
    for g, w in fields:
        diff = (g.to("cpu", torch.int64) != w.to("cpu", torch.int64)).any(dim=-1)
        bad += int(diff.sum())
    F = Fr("cpu")
    for pt, logs in points:
        xs, ys, zs = (_fq_ints(c) for c in pt)
        ks = F.to_ints(logs.cpu()).reshape(-1)
        for X, Y, Z, k in zip(xs, ys, zs, ks):
            if not g1.same_point((X, Y, Z), table.mul(int(k))):
                bad += 1
    return bad, total
