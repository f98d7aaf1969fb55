"""Plain BLS12-381 scalar-field arithmetic on int64 limb tensors.

The benchmark's own field, written from the textbook and independent of
the program under test: an element is an ``int64`` tensor ``[..., 16]`` of
16-bit limbs, least significant first, holding x * 2^256 mod r (the
Montgomery form with R = 2^256), canonical (below r).  The program's
``int32`` tables of the same form convert with ``.to(torch.int64)``.
Every operation is a short sequence of plain tensor ops that runs on the
CPU or on a card alike: a schoolbook product with a word-by-word
Montgomery reduction, sequential carries, column sums, and a tree for batch
inversion.
"""

from __future__ import annotations

import numpy as np
import torch

R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
"""The order r of BLS12-381's G1 (its scalar field)."""
GENERATOR = 7
"""The smallest multiplicative generator of the scalar field."""
TWO_ADICITY = 32
LIMBS = 16
BITS = 16
MASK = (1 << BITS) - 1
MONT_R = (1 << (BITS * LIMBS)) % R_MOD
MONT_R2 = pow(1 << (BITS * LIMBS), 2, R_MOD)
MONT_RINV = pow(1 << (BITS * LIMBS), -1, R_MOD)
N0 = (-pow(R_MOD, -1, 1 << BITS)) % (1 << BITS)


def int_limbs(x: int) -> list[int]:
    return [(x >> (BITS * i)) & MASK for i in range(LIMBS)]


def limbs_int(limbs) -> int:
    return sum(int(v) << (BITS * i) for i, v in enumerate(limbs))


def root_of_unity(order: int) -> int:
    """A primitive ``order``-th root of unity (``order`` a power of two):
    GENERATOR^((r - 1) / 2^32) squared down, arkworks' choice."""
    log = order.bit_length() - 1
    if order != 1 << log or log > TWO_ADICITY:
        raise ValueError(f"no root of unity of order {order}")
    root = pow(GENERATOR, (R_MOD - 1) >> TWO_ADICITY, R_MOD)
    for _ in range(TWO_ADICITY - log):
        root = root * root % R_MOD
    return root


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Limb-first columns [K, ...] -> limbs in [0, 2^16) below the top row,
    which keeps the (signed) rest; in place, serial."""
    for i in range(t.shape[0] - 1):
        t[i + 1] += t[i] >> BITS
        t[i] &= MASK
    return t


class Fr:
    """The scalar field's operations on one device."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._p = torch.tensor(int_limbs(R_MOD) + [0], dtype=torch.int64, device=self.device)

    # -- constants and conversions -------------------------------------
    def from_ints(self, values) -> torch.Tensor:
        """Python ints (any nesting) -> Montgomery tensor [..., 16]."""
        arr = np.asarray(values, dtype=object)
        flat = [int_limbs(int(v) % R_MOD * MONT_R % R_MOD) for v in arr.reshape(-1)]
        out = torch.tensor(flat, dtype=torch.int64, device=self.device).reshape(-1, LIMBS)
        return out.reshape(arr.shape + (LIMBS,))

    def const(self, value: int) -> torch.Tensor:
        return self.from_ints(value)

    def to_ints(self, t: torch.Tensor) -> np.ndarray:
        """Montgomery tensor [..., 16] -> object array of the values."""
        a = t.detach().to("cpu", torch.int64).numpy()
        flat = a.reshape(-1, LIMBS)
        out = np.empty(flat.shape[0], dtype=object)
        for i, row in enumerate(flat):
            out[i] = limbs_int(row) * MONT_RINV % R_MOD
        return out.reshape(a.shape[:-1])

    def from_raw(self, raw: torch.Tensor) -> torch.Tensor:
        """Limbs read as a plain integer below r -> that integer's Montgomery
        form: the product with the limbs of R^2 is x R^2 / R = x R."""
        r2 = torch.tensor(int_limbs(MONT_R2), dtype=torch.int64, device=self.device)
        return self.mul(raw.to(self.device, torch.int64), r2)

    def zeros(self, shape=()) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (LIMBS,), dtype=torch.int64, device=self.device)

    # -- ring operations ------------------------------------------------
    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """Limb-first [17, ...] value below 2r (top row 0 or 1 after the
        carry) -> canonical [16, ...]."""
        d = _carry(t - self._p.reshape((LIMBS + 1,) + (1,) * (t.ndim - 1)))
        return torch.where(d[LIMBS] >= 0, d, t)[:LIMBS]

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        s = torch.cat([(a + b).movedim(-1, 0), a.new_zeros((1,) + a.shape[:-1])])
        return self._reduce_once(_carry(s)).movedim(0, -1)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        d = _carry(torch.cat([(a - b).movedim(-1, 0), a.new_zeros((1,) + a.shape[:-1])]))
        neg = d[LIMBS] < 0
        p = self._p.reshape((LIMBS + 1,) + (1,) * (d.ndim - 1))
        e = _carry(d + p)
        return torch.where(neg, e, d)[:LIMBS].movedim(0, -1)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a b / 2^256 mod r: a schoolbook product in
        int64 columns (each below 16 * 2^32), then sixteen reduction steps
        of one limb each (m = t_i * (-r^-1) mod 2^16, t += m r 2^(16 i))."""
        a, b = torch.broadcast_tensors(a, b)
        A = a.movedim(-1, 0).contiguous()
        B = b.movedim(-1, 0).contiguous()
        t = torch.zeros((2 * LIMBS + 1,) + A.shape[1:], dtype=torch.int64, device=A.device)
        for i in range(LIMBS):
            t[i:i + LIMBS].addcmul_(B, A[i])
        p = self._p[:LIMBS].reshape((LIMBS,) + (1,) * (A.ndim - 1))
        for i in range(LIMBS):
            m = ((t[i] & MASK) * N0) & MASK
            t[i:i + LIMBS].addcmul_(p, m)
            t[i + 1] += t[i] >> BITS
        return self._reduce_once(_carry(t[LIMBS:])).movedim(0, -1)

    # -- reductions -----------------------------------------------------
    def sum(self, a: torch.Tensor, axis: int = -2) -> torch.Tensor:
        """Sum along a batch axis (not the limb axis): exact int64 column
        sums (each below M 2^16), carried into 19 limbs, the part above
        2^256 folded back as hi 2^256 = mont(hi, R^2) mod r, the rest
        brought below r by two conditional subtractions."""
        if axis < 0:
            axis += a.ndim
        if axis == a.ndim - 1:
            raise ValueError("cannot sum over the limb axis")
        x = a.movedim(axis, -2)
        if x.shape[-2] == 0:
            return self.zeros(x.shape[:-2])
        if x.shape[-2] <= 4:
            acc = x[..., 0, :]
            for i in range(1, x.shape[-2]):
                acc = self.add(acc, x[..., i, :])
            return acc
        cols = x.sum(dim=-2).movedim(-1, 0)
        t = _carry(torch.cat([cols, cols.new_zeros((3,) + cols.shape[1:])]))
        hi = torch.cat([t[LIMBS:], t.new_zeros((LIMBS - 3,) + t.shape[1:])]).movedim(0, -1)
        r2 = torch.tensor(int_limbs(MONT_R2), dtype=torch.int64, device=self.device)
        lo = torch.cat([t[:LIMBS], t.new_zeros((1,) + t.shape[1:])])
        lo = self._reduce_once(torch.cat([self._reduce_once(lo), t.new_zeros((1,) + t.shape[1:])]))
        return self.add(lo.movedim(0, -1), self.mul(hi, r2))

    def pow(self, a: torch.Tensor, e: int) -> torch.Tensor:
        acc = self.const(1).expand(a.shape).clone()
        for bit in bin(e)[2:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def batch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Inverse of every element along axis -2 (zero maps to zero): a
        product tree up, one Fermat inversion of the root, and the tree
        down again."""
        n = a.shape[-2]
        zero = (a == 0).all(dim=-1)
        one = self.const(1)
        x = torch.where(zero[..., None], one, a)
        size = 1 << max(n - 1, 0).bit_length()
        if size != n:
            pad = one.expand(a.shape[:-2] + (size - n, LIMBS))
            x = torch.cat([x, pad], dim=-2)
        levels = [x]
        while levels[-1].shape[-2] > 1:
            cur = levels[-1]
            levels.append(self.mul(cur[..., 0::2, :], cur[..., 1::2, :]))
        inv = self.pow(levels[-1], R_MOD - 2)
        for cur in reversed(levels[:-1]):
            left = self.mul(inv, cur[..., 1::2, :])
            right = self.mul(inv, cur[..., 0::2, :])
            inv = torch.stack([left, right], dim=-2).reshape(cur.shape)
        out = inv[..., :n, :]
        return torch.where(zero[..., None], torch.zeros_like(out), out)
