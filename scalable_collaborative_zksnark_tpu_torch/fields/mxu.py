"""Int8-matmul field arithmetic for shared-operand patterns (the "MXU" engine).

Mirrors the JAX package's ``fields/mxu.py``.  Two patterns of the sumcheck
rounds are contractions, which a matrix unit computes on bytes:

* ``dot_red``: the sum of products t = sum_i f_i * g_i over the evaluation
  axis is one int8 product of the byte-chunk matrices per batch entry;
* ``mul_shared``: the product of every element by one shared scalar r is
  one int8 product of the byte-chunk matrix against a small per-r matrix
  M_r whose row k holds the bytes of 2^(8k) * r * R^-1 mod p
  (``fold_matrix``, a few Montgomery products).

Representation ("red8"): ``Red(arr, bound)``, an ``int64`` tensor
``[..., W]`` of coefficients at byte positions, value = sum_k arr[k] 2^(8k),
every coefficient below the Python-int ``bound``.  Canonical Montgomery
limbs embed with bound 256; adds and subs grow the bound; every matmul
stage folds the value back mod p and resets it.  The bounds are static and
asserted, so no step can overflow.  The JAX package holds the coefficients
in ``uint32``; every bound it asserts is below 2^32 and no step relies on
wrap-around, so the ``int64`` coefficients here are the same integers.

The int8 products (``torch._int_mm``, int32 accumulation) take unsigned
bytes biased by -128, and the exact rank-1 corrections
128 * (sum a + sum b) - K * 128^2 are added back, computed on the true
contraction length and sums.  Each product's operands are padded in the
biased domain with zeros, which add nothing, to shapes the card's
``_int_mm`` takes (``_int8_mm``); the CPU takes the same padded shapes.  ``matmuls`` counts the int8
products made, on any device.  The JAX package computes these products
with ``jax.lax.dot_general`` outside any Pallas kernel: they are not TPU
kernels, and here they are PyTorch's int8 matmul on the device of the
operands.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as nnf

from .config import LIMB_BITS, LIMB_MASK, FieldSpec, int_to_limbs

# int8-matmul contraction cap: |sum (a-128)(b-128)| <= K * 2^14 < 2^29,
# and sum a * b <= K * 255^2 < 2^31.
MAX_CONTRACT = 1 << 15

matmuls = 0
"""Int8 products made (``torch._int_mm`` calls) since the last reset."""


def _bytes_of_int(x: int, nbytes: int) -> np.ndarray:
    assert 0 <= x < (1 << (8 * nbytes))
    return np.array([(x >> (8 * i)) & 0xFF for i in range(nbytes)], np.int64)


def value_of(arr) -> int:
    """Host side: integer value of a byte-position coefficient vector."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return sum(int(v) << (8 * i) for i, v in enumerate(np.asarray(arr).ravel().tolist()))


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@dataclass(frozen=True)
class MXUSpec:
    """Precomputed constants for one field (host side, hashable)."""

    spec: FieldSpec

    @property
    def L(self) -> int:
        return self.spec.num_limbs

    @property
    def W(self) -> int:  # byte width of one canonical element
        return 2 * self.spec.num_limbs

    @property
    def p(self) -> int:
        return self.spec.modulus

    @property
    def R(self) -> int:
        return 1 << (LIMB_BITS * self.L)

    @functools.cached_property
    def rinv(self) -> int:
        return pow(self.R, self.p - 2, self.p)

    @functools.lru_cache(maxsize=None)
    def pow8_mont(self, kmax: int) -> np.ndarray:
        """[kmax, L] plain limbs of 2^(8k) mod p: a Montgomery product of
        r-hat with row k is r-hat * 2^(8k) * R^-1 mod p, the row of the fold
        matrix M_r (the product's R^-1 is the one the fold needs)."""
        return _frozen(np.stack([int_to_limbs((1 << (8 * k)) % self.p, self.L)
                                 for k in range(kmax)]).astype(np.int32))

    @functools.lru_cache(maxsize=None)
    def red_rows(self, kmax: int, rinv_power: int = 0) -> np.ndarray:
        """[kmax, W] bytes of 2^(8k) * R^-s mod p."""
        rr = pow(self.rinv, rinv_power, self.p) if rinv_power else 1
        return _frozen(np.stack([_bytes_of_int((1 << (8 * k)) * rr % self.p, self.W)
                                 for k in range(kmax)]))


@functools.lru_cache(maxsize=None)
def mxu_spec(spec: FieldSpec) -> MXUSpec:
    return MXUSpec(spec)


# ---------------------------------------------------------------------------
# Redundant byte-position values with static bound tracking
# ---------------------------------------------------------------------------
@dataclass
class Red:
    """int64 byte-position coefficients [..., W] and their static bound:
    value(x) = sum_k arr[..., k] * 2^(8k), every coefficient < bound."""

    arr: torch.Tensor
    bound: int

    @property
    def W(self) -> int:
        return self.arr.shape[-1]


def to_red(mont_limbs: torch.Tensor) -> Red:
    """Canonical [..., L] 16-bit limbs -> red8 [..., 2L] bytes."""
    x = mont_limbs.to(torch.int64)
    st = torch.stack([x & 0xFF, x >> 8], dim=-1)
    return Red(st.reshape(st.shape[:-2] + (st.shape[-2] * 2,)), 256)


def _pad_w(arr: torch.Tensor, W: int) -> torch.Tensor:
    return arr if arr.shape[-1] == W else nnf.pad(arr, (0, W - arr.shape[-1]))


def add_red(a: Red, b: Red) -> Red:
    W = max(a.W, b.W)
    bound = a.bound + b.bound - 1
    assert bound < 1 << 32
    return Red(_pad_w(a.arr, W) + _pad_w(b.arr, W), bound)


@functools.lru_cache(maxsize=None)
def _sub_bias(spec: FieldSpec, W: int, coeff: int) -> tuple:
    """Constant D: D[k] in (coeff-256, coeff], value(D) = 0 mod p, so
    sub_red(a, b) = a + D - b is borrow-free and = a - b mod p."""
    mx = mxu_spec(spec)
    D = [coeff] * W
    corr = _bytes_of_int(value_of(np.array(D, dtype=object)) % mx.p, W)
    D = [d - int(c) for d, c in zip(D, corr)]
    assert sum(x << (8 * k) for k, x in enumerate(D)) % mx.p == 0
    assert all(0 <= x < 1 << 32 for x in D)
    return tuple(D)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def sub_red(spec: FieldSpec, a: Red, b: Red) -> Red:
    """a - b mod p as a + D - b.  Each coefficient of the result must stay
    nonnegative: D[k] - b[k] >= coeff - b.bound - 254, which the phases'
    bounds keep positive (coeff is the power of two above b.bound - 1, with
    at least 2^10); where it is not, a[k] must make up the difference, as
    in the JAX package, whose uint32 coefficients would wrap there."""
    W = max(a.W, b.W)
    coeff = 1 << max(b.bound - 1, 1 << 9).bit_length()
    D = _const(_sub_bias(spec, W, coeff), a.arr.device)
    bound = a.bound + coeff
    assert bound < 1 << 32
    return Red(_pad_w(a.arr, W) + D - _pad_w(b.arr, W), bound)


def _chunk(a: Red) -> tuple[torch.Tensor, int]:
    """Split coefficients into 8-bit chunks: [..., W] -> [..., n*W]; flat
    column t*W + k carries weight 2^(8*(k+t)), byte position k + t."""
    n = max(((a.bound - 1).bit_length() + 7) // 8, 1)
    parts = [(a.arr >> (8 * t)) & 0xFF for t in range(n)]
    return torch.cat(parts, dim=-1), n


def _chunk_positions(W: int, n: int) -> np.ndarray:
    """Byte position of each flat chunk column: t*W + k -> k + t."""
    return np.concatenate([np.arange(W) + t for t in range(n)])


def _group_positions(x: torch.Tensor, W: int, n: int, dim: int) -> torch.Tensor:
    """Sum the n*W chunk entries along ``dim`` by byte position:
    -> W + n - 1 positions (chunk t's block shifts by t)."""
    x = x.movedim(dim, -1)
    out = torch.zeros(x.shape[:-1] + (W + n - 1,), dtype=x.dtype, device=x.device)
    for t in range(n):
        out[..., t:t + W] += x[..., t * W:(t + 1) * W]
    return out.movedim(-1, dim)


# ---------------------------------------------------------------------------
# Exact unsigned-byte matmuls on int8 products
# ---------------------------------------------------------------------------
def _ceil(x: int, q: int) -> int:
    return -(-x // q) * q


def _int8_mm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] x [k, n] -> int32 [m, n] by ``torch._int_mm``, the
    operands padded with zeros to at least 24 rows and to widths that are
    multiples of 8, the second passed column-major: cuBLASLt (CUDA 12.8, on
    the H100) refuses the product of two row-major int8 operands for outer
    widths from 32 on, and takes every shape tried with this layout."""
    global matmuls
    (m, k), n = a8.shape, b8.shape[1]
    mp, kp, np_ = max(_ceil(m, 8), 24), _ceil(k, 8), _ceil(n, 8)
    if (mp, kp) != (m, k):
        a8 = nnf.pad(a8, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b8 = nnf.pad(b8, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a8.contiguous(), b8.t().contiguous().t())
    matmuls += 1
    return out[:m, :n]


def _biased(x: torch.Tensor) -> torch.Tensor:
    return (x - 128).to(torch.int8)


def _i8mm(a_bytes: torch.Tensor, b_bytes: torch.Tensor, b_colsum: torch.Tensor) -> torch.Tensor:
    """Exact sum_k a[..., k] * b[k, n] for byte-valued inputs:
    sum (a-128)(b-128) + 128*(sum a) + 128*(sum b) - K*128^2."""
    K = a_bytes.shape[-1]
    assert K <= MAX_CONTRACT, K
    lead = a_bytes.shape[:-1]
    m = _int8_mm(_biased(a_bytes).reshape(-1, K), _biased(b_bytes))
    m = m.reshape(lead + (b_bytes.shape[1],)).to(torch.int64)
    arow = a_bytes.sum(dim=-1, keepdim=True)
    return m + 128 * (arow + b_colsum) - K * 128 * 128


def _dot_batch(a_bytes: torch.Tensor, b_bytes: torch.Tensor) -> torch.Tensor:
    """Exact sum_i a[..., i, p] * b[..., i, q] -> [..., p, q] (contracts
    axis -2 of both), one int8 product per batch entry."""
    B, P, Q = a_bytes.shape[-2], a_bytes.shape[-1], b_bytes.shape[-1]
    assert B <= MAX_CONTRACT, B
    batch = a_bytes.shape[:-2]
    a8 = _biased(a_bytes).reshape(-1, B, P).transpose(1, 2).contiguous()  # [nb, P, B]
    b8 = _biased(b_bytes).reshape(-1, B, Q)
    m = torch.stack([_int8_mm(a8[i], b8[i]) for i in range(a8.shape[0])])
    m = m.reshape(batch + (P, Q)).to(torch.int64)
    sa = a_bytes.sum(dim=-2)  # [..., P]
    sb = b_bytes.sum(dim=-2)  # [..., Q]
    return m + 128 * (sa[..., :, None] + sb[..., None, :]) - B * 128 * 128


# ---------------------------------------------------------------------------
# Montgomery fold stages
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _red_rows_at(spec: FieldSpec, W: int, n: int, rinv_power: int, device: torch.device):
    """(rows [n*W, mx.W], their column sums) of ``reduce_red`` for chunks
    of a width-W value, on ``device``."""
    pos = _chunk_positions(W, n)
    rows = mxu_spec(spec).red_rows(int(pos.max()) + 1, rinv_power)[pos]
    return (torch.from_numpy(np.ascontiguousarray(rows)).to(device),
            torch.from_numpy(rows.sum(0)).to(device))


def reduce_red(spec: FieldSpec, x: Red, rinv_power: int = 0) -> Red:
    """Fold any red8 to width-W coefficients = value(x) * R^-s mod p."""
    ch, n = _chunk(x)
    rows, colsum = _red_rows_at(spec, x.W, n, rinv_power, x.arr.device)
    K = ch.shape[-1]
    bound = K * 255 * 255 + 1
    assert bound < 1 << 31
    return Red(_i8mm(ch, rows, colsum), bound)


def fold_matrix(spec: FieldSpec, F, r_mont: torch.Tensor, src_bound: int, src_W: int):
    """The shared-scalar matrix for :func:`mul_shared`.

    ``r_mont``: canonical Montgomery scalar [L].  Returns (M_r [kmax, W]
    bytes, kmax): row k holds the bytes of 2^(8k) * r * R^-1 mod p, from
    kmax Montgomery products (``F.mul``)."""
    mx = mxu_spec(spec)
    n = max(((src_bound - 1).bit_length() + 7) // 8, 1)
    kmax = src_W + n  # positions k + t reach src_W - 1 + n - 1
    pows = torch.from_numpy(mx.pow8_mont(kmax).copy()).to(r_mont.device)
    rows = F.mul(r_mont, pows).to(torch.int64)  # [kmax, L]
    st = torch.stack([rows & 0xFF, rows >> 8], dim=-1)
    return st.reshape(kmax, mx.W), kmax


def mul_shared(spec: FieldSpec, x: Red, m_r: torch.Tensor) -> Red:
    """Montgomery-multiply every element of ``x`` by one shared scalar.

    ``m_r``: [kmax, W] from :func:`fold_matrix` built with the same
    (src_bound, src_W) as ``x`` (kmax covers x's chunk positions)."""
    ch, n = _chunk(x)
    pos = _chunk_positions(x.W, n)
    assert int(pos.max()) + 1 <= m_r.shape[0], (pos.max(), m_r.shape)
    rows = m_r[torch.from_numpy(pos).to(m_r.device)]  # [K, W]
    K = ch.shape[-1]
    bound = K * 255 * 255 + 1
    assert bound < 1 << 31
    return Red(_i8mm(ch, rows, rows.sum(dim=0)), bound)


# ---------------------------------------------------------------------------
# Sum of products (contraction over the evaluation axis)
# ---------------------------------------------------------------------------
def _diag_sums(g: torch.Tensor) -> torch.Tensor:
    """Anti-diagonal sums of [..., P, Q] -> [..., P+Q-1] (pad and reshape:
    row p shifts right by p)."""
    P, Q = g.shape[-2], g.shape[-1]
    b = nnf.pad(g, (0, P)).reshape(g.shape[:-2] + (P * (Q + P),))
    b = b[..., : P * (Q + P - 1)].reshape(g.shape[:-2] + (P, Q + P - 1))
    return b.sum(dim=-2)


def dot_red(spec: FieldSpec, f: Red, g: Red) -> Red:
    """sum_i mont(f_i * g_i) over axis -2: [..., B, W] -> [..., W'].

    The result = (sum_i value(f_i) * value(g_i)) * R^-1 mod p.  The batch
    axis is contracted by int8 products; batches larger than MAX_CONTRACT
    are split and the (small) per-piece results added."""
    B = f.arr.shape[-2]
    if B > MAX_CONTRACT:
        pieces = [dot_red(spec, Red(f.arr[..., s:s + MAX_CONTRACT, :], f.bound),
                          Red(g.arr[..., s:s + MAX_CONTRACT, :], g.bound))
                  for s in range(0, B, MAX_CONTRACT)]
        return functools.reduce(add_red, pieces)

    fc, nf = _chunk(f)  # [..., B, Kf]
    gc, ng = _chunk(g)
    gmat = _dot_batch(fc, gc)  # [..., Kf, Kg], exact, 0 <= gmat < 2^31
    Pf, Pg = f.W + nf - 1, g.W + ng - 1

    def pos_sum(m):  # [..., Kf, Kg] -> [..., Pf, Pg]
        return _group_positions(_group_positions(m, f.W, nf, -2), g.W, ng, -1)

    # split into 16-bit halves before the position and diagonal sums
    dlo = _diag_sums(pos_sum(gmat & 0xFFFF))  # [..., Pf+Pg-1]
    dhi = _diag_sums(pos_sum(gmat >> 16))
    b_lo = min(Pf, Pg) * nf * ng * ((1 << 16) - 1) + 1
    b_hi = min(Pf, Pg) * nf * ng * ((1 << 15) - 1) + 1
    W = Pf + Pg - 1 + 2
    arr = _pad_w(dlo, W) + nnf.pad(dhi, (2, 0))
    bound = b_lo + b_hi
    assert bound < 1 << 32
    return reduce_red(spec, Red(arr, bound), rinv_power=1)


def sum_red(spec: FieldSpec, f: Red) -> Red:
    """Plain sum over axis -2: [..., B, W] -> [..., W'] = sum_i value(f_i)
    (no R^-1 factor; the single-table round messages)."""
    B = f.arr.shape[-2]
    if B > MAX_CONTRACT:
        pieces = [sum_red(spec, Red(f.arr[..., s:s + MAX_CONTRACT, :], f.bound))
                  for s in range(0, B, MAX_CONTRACT)]
        return functools.reduce(add_red, pieces)
    fc, nf = _chunk(f)  # [..., B, K]
    ones = torch.ones(fc.shape[:-1] + (1,), dtype=torch.int64, device=fc.device)
    cs = _dot_batch(fc, ones)[..., 0]  # [..., K], exact, < B * 255
    by_pos = _group_positions(cs, f.W, nf, -1)
    bound = nf * B * 255 + 1
    assert bound < 1 << 32
    x = Red(by_pos, bound)
    return reduce_red(spec, x, rinv_power=0) if bound > 1 << 26 else x


# ---------------------------------------------------------------------------
# Canonicalization (phase boundaries)
# ---------------------------------------------------------------------------
def canon(spec: FieldSpec, F, x: Red) -> torch.Tensor:
    """red8 -> canonical Montgomery limbs int32 [..., L] (value mod p).

    Iterated ripple carry and top-carry fold with static bound tracking:
    each round replaces the carry c (weight 2^(8W)) by c * (2^(8W) mod p),
    shrinking the value by (R mod p) / R (< 0.1x for both BLS fields);
    the loop runs until the tracked carry bound is zero, then a constant
    ladder of conditional subtracts lands in [0, p).  ``F`` is unused, as
    in the JAX package."""
    mx = mxu_spec(spec)
    y = x
    while y.bound > 1 << 24 or y.W != mx.W:
        y = reduce_red(spec, y, rinv_power=0)  # W = mx.W, bound < 2^24.2

    def ripple(arr):
        c = torch.zeros_like(arr[..., 0])
        outs = []
        for k in range(mx.W):
            s = arr[..., k] + c
            outs.append(s & 0xFF)
            c = s >> 8
        return torch.stack(outs, dim=-1), c

    rp_bytes = _const(tuple(_bytes_of_int(mx.R % mx.p, mx.W).tolist()), y.arr.device)
    rmodp = mx.R % mx.p
    assert 2 * rmodp < mx.R  # holds for 16-bit-limb Montgomery fields
    geom = ((1 << (8 * mx.W)) - 1) // 255  # sum_k 2^(8k)
    vb = (y.bound - 1) * geom  # value bound (inclusive)
    arr = y.arr
    for _ in range(64):  # bound-driven, about 6 rounds
        cb = vb >> (8 * mx.W)
        bytes_, c = ripple(arr)
        if cb == 0:
            arr = bytes_
            break
        assert cb * 255 < 1 << 32  # coefficient bound
        arr = bytes_ + c[..., None] * rp_bytes
        if cb == 1:
            # the value was < R + (R mod p); after this fold it is
            # < max(R, 2 (R mod p)) = R, so the next ripple carries 0
            vb = mx.R - 1
        else:
            vb = (1 << (8 * mx.W)) - 1 + cb * rmodp
    else:  # pragma: no cover - bound tracking guarantees termination
        raise AssertionError("canon did not converge")
    limbs = torch.stack([arr[..., 2 * j] + (arr[..., 2 * j + 1] << 8) for j in range(mx.L)],
                        dim=-1)
    # value < R: subtract p << s for s = floor(log2(R/p)) .. 0
    s_top = (mx.R // mx.p).bit_length() - 1
    for s in range(s_top, -1, -1):
        if (mx.p << s) < (1 << (16 * mx.L)):
            limbs = _cond_sub_const(limbs, mx.p << s, mx.L)
    return limbs.to(torch.int32)


def _cond_sub_const(limbs: torch.Tensor, sub_val: int, L: int) -> torch.Tensor:
    """Subtract ``sub_val`` iff limbs >= sub_val (16-bit borrow chain)."""
    sub = int_to_limbs(sub_val, L)
    borrow = torch.zeros_like(limbs[..., 0])
    diff = []
    for j in range(L):
        d = limbs[..., j] - int(sub[j]) - borrow
        borrow = (d < 0).to(torch.int64)
        diff.append(d & LIMB_MASK)
    take = borrow == 0
    return torch.where(take[..., None], torch.stack(diff, dim=-1), limbs)
