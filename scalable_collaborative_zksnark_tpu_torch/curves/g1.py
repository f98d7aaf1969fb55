"""Batched short-Weierstrass G1 arithmetic in Jacobian coordinates (PyTorch).

Mirrors the JAX package's ``curves/g1.py``.  A point batch is a
``PointJ(x, y, z)`` of Fq tensors ``int32 [..., 24]`` in Montgomery form
(x = X/Z^2, y = Y/Z^3; Z = 0 is infinity, written (0, 1, 0)) -- the same
bits as the JAX package's ``PointJ``.  ``add``, ``add_mixed``,
``add_mixed_masked``, ``add_mixed_reset``, ``double`` and ``scalar_mul``
go through ``cuda_g1`` (a CUDA kernel for tensors on the
card, the plain version on the CPU); everything else is plain tensor code
on those and on the ``Field`` ops.

A ``Curve`` is bound to the device of its fields; ``bls12_381_g1()``
defaults to CUDA and raises where there is none.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT, resolve
from ..fields.config import int_to_limbs
from ..fields.fr import Field, get_field
from . import cuda_g1


class PointJ(NamedTuple):
    """Jacobian point batch (three int32 limb tensors of one shape)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[:-1]


def map_points(fn, *pts: PointJ) -> PointJ:
    """Apply ``fn`` coordinate by coordinate (``jax.tree.map`` over points)."""
    return PointJ(*(fn(*cs) for cs in zip(*pts)))


class Curve:
    """y^2 = x^3 + b over a base field (a = 0), with batched ops on one device."""

    def __init__(self, name: str, fq: Field, b: int, fr: Field):
        self.name = name
        self.fq = fq
        self.fr = fr
        self.b = b

    def __hash__(self):
        return hash((self.name, str(self.device)))

    def __eq__(self, other):
        return isinstance(other, Curve) and (self.name, self.device) == (other.name, other.device)

    def __repr__(self):
        return f"Curve({self.name}, {self.device})"

    @property
    def device(self) -> torch.device:
        return self.fq.device

    # -- constructors ----------------------------------------------------
    def infinity(self, shape=()) -> PointJ:
        return PointJ(*cuda_g1.infinity(self.fq.spec, shape, self.device))

    def from_affine_ints(self, coords) -> PointJ:
        """List of (x, y) int pairs or None (infinity) -> batched PointJ."""
        xs, ys, zs = [], [], []
        for c in coords:
            xs.append(0 if c is None else c[0])
            ys.append(1 if c is None else c[1])
            zs.append(0 if c is None else 1)
        return PointJ(*(self.fq.array_from_ints(v) for v in (xs, ys, zs)))

    def to_affine_ints(self, pt: PointJ):
        """Batched PointJ -> list of (x, y) tuples or None (host side)."""
        X, Y, Z = (self.fq.array_to_ints(a).reshape(-1) for a in pt)
        p = self.fq.p
        out = []
        for xi, yi, zi in zip(X, Y, Z):
            xi, yi, zi = int(xi), int(yi), int(zi)
            if zi == 0:
                out.append(None)
            else:
                zinv = pow(zi, -1, p)
                out.append((xi * zinv * zinv % p, yi * zinv * zinv * zinv % p))
        return out

    # -- core group law --------------------------------------------------
    def double(self, pt: PointJ) -> PointJ:
        return PointJ(*cuda_g1.double(self.fq.spec, pt))

    def add(self, p1: PointJ, p2: PointJ) -> PointJ:
        """Complete p1 + p2; operands broadcast."""
        return PointJ(*cuda_g1.add(self.fq.spec, p1, p2))

    def add_mixed(self, p1: PointJ, p2: PointJ) -> PointJ:
        """p1 (Jacobian) + p2 with z2 in {0, 1} (affine or infinity)."""
        return PointJ(*cuda_g1.add_mixed(self.fq.spec, p1, p2))

    def add_mixed_masked(self, p1: PointJ, p2: PointJ, valid: torch.Tensor) -> PointJ:
        """valid ? p1 + p2 (mixed) : p1 -- the non-dense MSM's bucket step."""
        return PointJ(*cuda_g1.add_masked(self.fq.spec, p1, p2, valid))

    def add_mixed_reset(self, p1: PointJ, p2: PointJ, same: torch.Tensor) -> PointJ:
        """same ? p1 + p2 (mixed) : p2 -- a segment step that restarts at p2."""
        return PointJ(*cuda_g1.add_reset(self.fq.spec, p1, p2, same))

    def normalize(self, pt: PointJ) -> PointJ:
        """Jacobian -> affine-or-infinity (z in {0, 1}), batched: one batch
        inversion over the flattened points; infinity becomes (0, 1, 0)."""
        F = self.fq
        shape = pt.x.shape[:-1]
        flat = map_points(lambda a: a.reshape(-1, a.shape[-1]), pt)
        zinv = F.batch_inv(flat.z)  # inv(0) = 0
        zi2 = F.sqr(zinv)
        x = F.mul(flat.x, zi2)
        y = F.mul(flat.y, F.mul(zi2, zinv))
        inf = F.is_zero(flat.z)[..., None]
        one = F.ones(flat.z.shape[:-1])
        zero = F.zeros(flat.z.shape[:-1])
        out = PointJ(torch.where(inf, zero, x), torch.where(inf, one, y),
                     torch.where(inf, zero, one))
        return map_points(lambda a: a.reshape(shape + a.shape[-1:]), out)

    def neg(self, pt: PointJ) -> PointJ:
        return PointJ(pt.x, self.fq.neg(pt.y), pt.z)

    def select(self, cond: torch.Tensor, a: PointJ, b: PointJ) -> PointJ:
        """Elementwise cond ? a : b (cond shaped like the batch)."""
        return PointJ(*cuda_g1.select(cond, a, b))

    # -- reductions ------------------------------------------------------
    def sum(self, pt: PointJ, axis: int = 0) -> PointJ:
        """Tree-reduction point sum along a batch axis."""
        if axis < 0:
            axis = pt.x.ndim - 1 + axis
        p = pt
        n = p.x.shape[axis]
        while n > 1:
            half = n // 2
            s = self.add(map_points(lambda a: a.narrow(axis, 0, half), p),
                         map_points(lambda a: a.narrow(axis, half, half), p))
            if n % 2:
                rest = map_points(lambda a: a.narrow(axis, 2 * half, n - 2 * half), p)
                s = map_points(lambda a, b: torch.cat([a, b], dim=axis), s, rest)
                n = half + 1
            else:
                n = half
            p = s
        return map_points(lambda a: a.squeeze(axis), p)

    # -- scalar multiplication -------------------------------------------
    def scalar_mul(self, pt: PointJ, scalar_std: torch.Tensor) -> PointJ:
        """Multiply by per-element scalars given as standard-form 16-bit
        limbs ``[..., n]`` (batch shapes broadcast): MSB-first double-and-add."""
        return PointJ(*cuda_g1.scalar_mul(self.fq.spec, pt, scalar_std))

    def scalar_limbs(self, values) -> torch.Tensor:
        """Host ints (object array) -> standard-form Fr limb tensor."""
        arr = np.asarray(values, dtype=object)
        limbs = np.stack([int_to_limbs(int(v) % self.fr.p, self.fr.L) for v in arr.reshape(-1)])
        return self.fr._tensor(limbs.reshape(arr.shape + (self.fr.L,)))

    def scalar_mul_int(self, pt: PointJ, scalars) -> PointJ:
        """Multiply by host-known int scalars (list broadcastable to the batch)."""
        return self.scalar_mul(pt, self.scalar_limbs(scalars))

    # -- fixed linear maps (PSS over G1) ---------------------------------
    def linear_map(self, matrix_obj: np.ndarray, pts: PointJ) -> PointJ:
        """out[..., o] = sum_i M[o, i] * P[..., i] for a fixed [out, in] int
        matrix over the points axis (-1): one batched double-and-add over all
        (o, i) products, then a tree sum over i."""
        n_out, n_in = matrix_obj.shape
        scal = self.scalar_limbs(matrix_obj)  # [out, in, Lr]
        ptb = map_points(lambda a: a[..., None, :, :].expand(
            a.shape[:-2] + (n_out, n_in, a.shape[-1])), pts)
        return self.sum(self.scalar_mul(ptb, scal), axis=-1)

    # -- validity --------------------------------------------------------
    def is_on_curve(self, pt: PointJ) -> torch.Tensor:
        """Y^2 == X^3 + b Z^6 (Jacobian), or infinity."""
        F = self.fq
        lhs = F.sqr(pt.y)
        z2 = F.sqr(pt.z)
        z6 = F.mul(F.sqr(z2), z2)
        rhs = F.add(F.mul(F.sqr(pt.x), pt.x), F.mul(F.const(self.b), z6))
        return F.is_zero(pt.z) | F.equal(lhs, rhs)

    def equal(self, p1: PointJ, p2: PointJ) -> torch.Tensor:
        """Projective equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3."""
        F = self.fq
        z11, z22 = F.sqr(p1.z), F.sqr(p2.z)
        ex = F.equal(F.mul(p1.x, z22), F.mul(p2.x, z11))
        ey = F.equal(F.mul(F.mul(p1.y, p2.z), z22), F.mul(F.mul(p2.y, p1.z), z11))
        inf1, inf2 = F.is_zero(p1.z), F.is_zero(p2.z)
        return torch.where(inf1 & inf2, True, torch.where(inf1 ^ inf2, False, ex & ey))


# ---------------------------------------------------------------------------
# Standard instances
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _curve(name: str, device: torch.device) -> Curve:
    fq, fr, b = {"bls12_381_g1": ("bls12_381_fq", "bls12_381_fr", 4),
                 "bls12_377_g1": ("bls12_377_fq", "bls12_377_fr", 1)}[name]
    return Curve(name, get_field(fq, device), b, get_field(fr, device))


def bls12_381_g1(device=DEFAULT) -> Curve:
    return _curve("bls12_381_g1", resolve(device))


def bls12_377_g1(device=DEFAULT) -> Curve:
    return _curve("bls12_377_g1", resolve(device))


# Standard generator of BLS12-381 G1 (draft-irtf-cfrg-pairing-friendly-curves).
BLS12_381_G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
