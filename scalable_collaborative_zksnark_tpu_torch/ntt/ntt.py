"""Batched radix-2 NTT / inverse NTT over a prime field (PyTorch).

Mirrors the JAX package's ``ntt/ntt.py`` and arkworks'
``Radix2EvaluationDomain``:

* ``ntt(F, dom, coeffs)``  == ``domain.fft(coeffs)``: evaluate the
  polynomial with little-endian coefficients at ``offset * g^i``;
* ``intt(F, dom, evals)``  == ``domain.ifft(evals)``;
* inputs shorter than the domain are zero-padded, longer ones truncated
  (arkworks' ``fft_in_place`` resize, which the PSS maps rely on).

Iterative Cooley-Tukey (decimation in time) with host-precomputed
twiddles: each stage is one batched field multiply plus an add and a sub
over the whole table, so the field kernels carry the transform.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..fields.fr import Field
from ..utils import timer


@dataclass(frozen=True)
class Domain:
    """A (possibly coset) radix-2 evaluation domain of size n."""

    field_name: str
    size: int
    offset: int = 1  # 1 for plain domains, F.generator for PSS secret cosets

    def __post_init__(self):
        if self.size & (self.size - 1) or self.size < 1:
            raise ValueError(f"domain size {self.size} is not a power of two")


@functools.lru_cache(maxsize=None)
def _stage_tables(field: Field, size: int, offset: int, inverse: bool):
    """(twiddles per stage [m, L], pre_scale [size, L] | None,
    post_scale [size, L] | None) as tensors on the field's device."""
    p = field.p
    g = field.spec.root_of_unity(size) if size > 1 else 1
    if inverse:
        g = pow(g, -1, p)
    logn = size.bit_length() - 1

    def table(values):
        return field.array_from_ints(values)

    twiddles = []
    for s in range(logn):
        m = 1 << s
        w = pow(g, size // (2 * m), p)
        twiddles.append(table([pow(w, j, p) for j in range(m)]))

    pre_scale = post_scale = None
    if not inverse and offset != 1:
        # evaluate at offset*g^i: scale coefficient k by offset^k first
        pre_scale = table([pow(offset, k, p) for k in range(size)])
    if inverse:
        ninv = pow(size, -1, p)
        off_inv = pow(offset, -1, p) if offset != 1 else 1
        post_scale = table([ninv * pow(off_inv, k, p) % p for k in range(size)])
    return twiddles, pre_scale, post_scale


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def _fit(field: Field, x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad or truncate the second-to-last axis to length n."""
    cur = x.shape[-2]
    if cur < n:
        pad = torch.zeros(x.shape[:-2] + (n - cur, field.L), dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=-2)
    elif cur > n:
        x = x[..., :n, :]
    return x


def _transform(field: Field, x: torch.Tensor, size: int, offset: int, inverse: bool):
    x = _fit(field, x, size)
    if size == 1:
        return x
    twiddles, pre_scale, post_scale = _stage_tables(field, size, offset, inverse)
    if pre_scale is not None:
        x = field.mul(x, pre_scale)
    timer.count("sync.upload.ntt_perm")
    perm = torch.from_numpy(_bit_reverse_perm(size)).to(x.device)
    x = x.index_select(-2, perm)
    batch = x.shape[:-2]
    for s in range(size.bit_length() - 1):
        m = 1 << s
        xb = x.reshape(batch + (size >> (s + 1), 2, m, field.L))
        lo = xb[..., 0, :, :]
        hi = field.mul(xb[..., 1, :, :], twiddles[s])
        x = torch.stack([field.add(lo, hi), field.sub(lo, hi)], dim=-3).reshape(
            batch + (size, field.L)
        )
    if post_scale is not None:
        x = field.mul(x, post_scale)
    return x


def ntt(field: Field, dom: Domain, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate (little-endian coeffs) on the domain; arkworks ``fft``."""
    return _transform(field, coeffs, dom.size, dom.offset, inverse=False)


def intt(field: Field, dom: Domain, evals: torch.Tensor) -> torch.Tensor:
    """Interpolate evaluations on the domain; arkworks ``ifft``."""
    return _transform(field, evals, dom.size, dom.offset, inverse=True)


# ---------------------------------------------------------------------------
# Four-step NTT
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _four_step_tables(field: Field, n: int, rows: int, offset: int):
    """(pre [rows, cols, L] | None, twiddle [rows, cols, L]):
    ``pre[r, q] = offset^(q*rows + r)`` and ``twiddle[r, k2] = w_n^(r*k2)``."""
    cols = n // rows
    p = field.p
    g = field.spec.root_of_unity(n)
    tw = [[pow(g, r * k2, p) for k2 in range(cols)] for r in range(rows)]
    pre = None
    if offset != 1:
        pre = field.array_from_ints(
            [[pow(offset, q * rows + r, p) for q in range(cols)] for r in range(rows)]
        )
    return pre, field.array_from_ints(tw)


def ntt_4step(field: Field, dom: Domain, coeffs: torch.Tensor, rows: int) -> torch.Tensor:
    """Four-step (Bailey) NTT of size n = rows * cols; output in standard
    order, identical to ``ntt``.

    Writing i = q*rows + r and k = k1*cols + k2: a length-cols DFT over q
    for each r, the twiddle w_n^(r*k2), then a length-rows DFT over r."""
    n = dom.size
    if n % rows:
        raise ValueError(f"rows {rows} does not divide {n}")
    cols = n // rows
    x = _fit(field, coeffs, n)
    batch = x.shape[:-2]
    pre, tw = _four_step_tables(field, n, rows, dom.offset)
    x = x.reshape(batch + (cols, rows, field.L)).transpose(-3, -2)  # [rows, cols]
    if pre is not None:
        x = field.mul(x, pre)
    x = ntt(field, Domain(field.spec.name, cols, 1), x)
    x = field.mul(x, tw)
    x = x.transpose(-3, -2)  # [k2, r]
    x = ntt(field, Domain(field.spec.name, rows, 1), x)
    x = x.transpose(-3, -2)  # [k1, k2]
    return x.reshape(batch + (n, field.L))
