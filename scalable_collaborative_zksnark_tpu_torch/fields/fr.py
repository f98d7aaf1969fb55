"""Batched prime-field arithmetic on 16-bit limb tensors (PyTorch).

Mirrors the JAX package's ``fields/fr.py``.  Elements are ``int32``
tensors ``[..., L]`` of 16-bit limbs (little-endian) in Montgomery form,
R = 2**(16L); the bits equal the JAX package's ``uint32`` arrays.  ``mul``,
``add`` and ``sub`` go through ``cuda_fr``: a CUDA kernel for tensors on
the card, the plain ``int64`` version for tensors on the CPU.  Everything
else (sums, inversion, encoding) is plain tensor code built on those
three, as the JAX package builds it on its Pallas kernels.

A ``Field`` is bound to a device: constants and random elements are made
there.  ``get_field(name)`` defaults to CUDA and raises where there is
none.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import DEFAULT, resolve
from . import cuda_fr
from .config import FIELDS, LIMB_BITS, FieldSpec, int_to_limbs, limbs_to_int

# Terms per column-sum chunk: int64 columns of 16-bit limbs stay < 2^30,
# so the carry out of a chunk is < 2^16 and fits one limb.
SUM_CHUNK = 1 << 14


def reduce_cols(spec: FieldSpec, cols: torch.Tensor, mul, add) -> torch.Tensor:
    """Columns ``[..., L]`` (each < 2^30) -> canonical int32 element.

    The carry-out c at 2^(16L) folds back in as c * R mod p, one
    Montgomery product by R^2 (``mul``/``add`` are the field ops to use:
    the dispatching wrappers, or the plain versions)."""
    L = spec.num_limbs
    p = spec.modulus
    limbs, carry = cuda_fr.normalize(cols.to(torch.int64))
    carry_el = torch.zeros_like(limbs)
    carry_el[..., 0] = carry
    r2 = torch.from_numpy(spec.r2_limbs.astype(np.int32)).to(cols.device)
    carry_contrib = mul(spec, carry_el.to(torch.int32), r2)
    # value(limbs) < 2^(16L), which can exceed 2p: ladder down with p << s
    R = 1 << (LIMB_BITS * L)
    for s in range((R // p).bit_length() - 1, 0, -1):
        if (p << s) < R:
            diff, borrow = cuda_fr.normalize(limbs - cuda_fr.limbs_const(p << s, L, limbs.device))
            limbs = torch.where((borrow >= 0)[..., None], diff, limbs)
    limbs = cuda_fr.cond_sub_p(spec, limbs, torch.zeros_like(carry))
    return add(spec, limbs.to(torch.int32), carry_contrib)


def column_sum(spec: FieldSpec, a: torch.Tensor, axis: int, mul, add) -> torch.Tensor:
    """Field sum along ``axis`` (not the limb axis) by exact int64 column
    sums over chunks of ``SUM_CHUNK`` terms, each reduced mod p."""
    if axis < 0:
        axis += a.ndim
    if axis == a.ndim - 1:
        raise ValueError("cannot sum over the limb axis")
    while a.shape[axis] > 1:
        n = a.shape[axis]
        take = min(n, SUM_CHUNK)
        pad = (-n) % take
        if pad:
            zshape = list(a.shape)
            zshape[axis] = pad
            a = torch.cat([a, torch.zeros(zshape, dtype=a.dtype, device=a.device)], dim=axis)
        shp = list(a.shape)
        shp[axis : axis + 1] = [shp[axis] // take, take]
        cols = a.to(torch.int64).reshape(shp).sum(dim=axis + 1)
        a = reduce_cols(spec, cols, mul, add)
    return a.squeeze(axis)


class Field:
    """Batched arithmetic for one prime field on one device.

    Methods take and return ``int32 [..., L]`` Montgomery tensors unless
    noted; inputs must be canonical (< p)."""

    def __init__(self, spec: FieldSpec, device=DEFAULT):
        self.spec = spec
        self.device = resolve(device)
        self.L = spec.num_limbs
        self.p = spec.modulus

    def __hash__(self):
        return hash((self.spec.name, str(self.device)))

    def __eq__(self, other):
        return (
            isinstance(other, Field)
            and self.spec.name == other.spec.name
            and self.device == other.device
        )

    def __repr__(self):
        return f"Field({self.spec.name}, {self.device})"

    # ------------------------------------------------------------------
    # Host conversions
    # ------------------------------------------------------------------
    def to_mont_int(self, x: int) -> np.ndarray:
        """Python int -> Montgomery limb vector (host side, uint32)."""
        return int_to_limbs(x * self.spec.r % self.p, self.L)

    def from_mont_limbs(self, limbs) -> int:
        """Montgomery limb vector -> Python int (host side)."""
        return limbs_to_int(np.asarray(limbs)) * self.spec.rinv % self.p

    def _tensor(self, arr_u32: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr_u32, dtype=np.uint32).view(np.int32)).to(
            self.device
        )

    def array_from_ints(self, xs) -> torch.Tensor:
        """Nested list/array of Python ints -> [..., L] Montgomery tensor."""
        xs = np.asarray(xs, dtype=object)
        flat = xs.reshape(-1)
        out = np.empty((flat.shape[0], self.L), dtype=np.uint32)
        for i, v in enumerate(flat):
            out[i] = self.to_mont_int(int(v) % self.p)
        return self._tensor(out.reshape(xs.shape + (self.L,)))

    def array_to_ints(self, arr: torch.Tensor) -> np.ndarray:
        """[..., L] Montgomery tensor -> object ndarray of Python ints."""
        a = arr.detach().cpu().numpy().view(np.uint32)
        flat = a.reshape(-1, self.L)
        out = np.empty((flat.shape[0],), dtype=object)
        for i in range(flat.shape[0]):
            out[i] = self.from_mont_limbs(flat[i])
        return out.reshape(a.shape[:-1])

    # ------------------------------------------------------------------
    # Constants
    # ------------------------------------------------------------------
    def zeros(self, shape=()) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.L,), dtype=torch.int32, device=self.device)

    def ones(self, shape=()) -> torch.Tensor:
        """1 in Montgomery form is R mod p."""
        return self._tensor(self.spec.r_limbs).expand(tuple(shape) + (self.L,))

    def const(self, x: int, shape=()) -> torch.Tensor:
        return self._tensor(self.to_mont_int(x % self.p)).expand(tuple(shape) + (self.L,))

    # ------------------------------------------------------------------
    # Ring operations
    # ------------------------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return cuda_fr.add(self.spec, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return cuda_fr.sub(self.spec, a, b)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a * b * R^{-1} mod p."""
        return cuda_fr.mul(self.spec, a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(self.zeros(a.shape[:-1]), a)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def encode(self, standard: torch.Tensor) -> torch.Tensor:
        """standard-form limbs -> Montgomery form."""
        return self.mul(standard, self._tensor(self.spec.r2_limbs))

    def decode(self, mont: torch.Tensor) -> torch.Tensor:
        """Montgomery form -> standard-form limbs."""
        return self.mul(mont, self._tensor(int_to_limbs(1, self.L)))

    # ------------------------------------------------------------------
    # Exponentiation / inversion
    # ------------------------------------------------------------------
    def pow_const(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a fixed Python-int exponent (square-and-multiply, MSB first)."""
        acc = self.ones(a.shape[:-1])
        for bit in bin(e)[2:] if e else "":
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Batched inversion by Fermat (a^(p-2)); inv(0) = 0."""
        return self.pow_const(a, self.p - 2)

    def _scan_mul(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive prefix products along axis -2 (log-depth)."""
        d = 1
        while d < x.shape[-2]:
            x = torch.cat([x[..., :d, :], self.mul(x[..., d:, :], x[..., :-d, :])], dim=-2)
            d *= 2
        return x

    def batch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Invert along axis -2 with the Montgomery trick; zero maps to zero."""
        is_zero = self.is_zero(a)
        safe = torch.where(is_zero[..., None], self.ones(a.shape[:-1]), a)
        prefix = self._scan_mul(safe)
        suffix = self._scan_mul(safe.flip(-2)).flip(-2)
        total_inv = self.inv(prefix[..., -1:, :])
        ones = self.ones(a.shape[:-2] + (1,))
        left = torch.cat([ones, prefix[..., :-1, :]], dim=-2)
        right = torch.cat([suffix[..., 1:, :], ones], dim=-2)
        out = self.mul(self.mul(left, right), total_inv)
        return torch.where(is_zero[..., None], self.zeros(a.shape[:-1]), out)

    # ------------------------------------------------------------------
    # Predicates / reductions
    # ------------------------------------------------------------------
    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=-1)

    def equal(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=-1)

    def sum(self, a: torch.Tensor, axis: int = -2) -> torch.Tensor:
        """Field sum along ``axis`` (an axis of the batch, not the limb axis)."""
        return column_sum(self.spec, a, axis, cuda_fr.mul, cuda_fr.add)

    def _reduce_u32_cols(self, cols: torch.Tensor) -> torch.Tensor:
        """Reduce limb columns (each < 2^30) to a canonical element."""
        return reduce_cols(self.spec, cols, cuda_fr.mul, cuda_fr.add)

    # ------------------------------------------------------------------
    # Random elements (host-side deterministic)
    # ------------------------------------------------------------------
    def random(self, shape, seed: int, rows: slice | None = None) -> torch.Tensor:
        """Deterministic pseudo-uniform elements in Montgomery form.

        Draws exactly as the JAX package's ``Field.random``: the same
        ``RandomState`` call, the top limb reduced below p's top limb, then
        encoded on the device -- so both packages make the same bits.
        ``rows``: keep only these rows of the draw's first axis, cut on the
        host before the upload."""
        shape = tuple(shape)
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        limbs = rng.randint(0, 1 << LIMB_BITS, size=shape + (self.L,)).astype(np.uint32)
        if rows is not None:
            limbs = np.ascontiguousarray(limbs[rows])
        top = int(self.spec.p_limbs[self.L - 1])
        limbs[..., self.L - 1] %= max(top, 1)
        return self.encode(self._tensor(limbs))


@functools.lru_cache(maxsize=None)
def _field(name: str, device: torch.device) -> Field:
    return Field(FIELDS[name], device)


def get_field(name: str, device=DEFAULT) -> Field:
    """The ``Field`` for a name in ``FIELDS`` on ``device`` (default CUDA)."""
    return _field(name, resolve(device))
