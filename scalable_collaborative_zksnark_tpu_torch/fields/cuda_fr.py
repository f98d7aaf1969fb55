"""Elementwise field kernels: CUDA wrappers and their plain PyTorch versions.

Replaces ``fields/pallas_fr.py`` (``_mul_kernel``, ``_add_kernel``,
``_sub_kernel`` behind ``pallas_fr.binary``).  The kernels are ``csrc/fr.cu`` on the
word arithmetic of ``csrc/fr.cuh``; see that file for the design and
what bounds it.

Layout at the boundary: ``int32 [..., L]`` 16-bit limbs in Montgomery form
(L = 16 for Fr, 24 for Fq).  Inputs must be canonical (< p); outputs are
canonical.  ``mul``/``add``/``sub`` broadcast their operands as
``torch.broadcast_tensors`` does.  A CPU tensor goes through the plain
version (``*_plain``), a CUDA tensor through the kernel; a failed build or
launch raises.  Each wrapper counts its kernel launches in ``.launches``.

The plain versions compute in ``int64`` on 16-bit limbs (Montgomery
reduction for the product); they are the reference the tests and
``chip_smoke.py`` hold the kernels to, and nothing on the card's path
calls them.

``mul_limb_major`` and ``mul_tiled`` are the same Fr product in the
limb-major layouts of the JAX package's ``scripts/exp_fieldmul.py``
(replacing its ``mont_kernel_lm`` and ``mont_kernel_lm2``): ``int32 [16,
M]`` with M a multiple of 1,024, and ``[M / 4096, 16, 8, 512]``.  Their
plain versions run that script's own 16-bit CIOS limb by limb
(``mul_cios16_plain``), a different schedule from ``mul_plain``'s column
sums.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build
from .config import LIMB_BITS, LIMB_MASK, FieldSpec, int_to_limbs

_OPS = {"mul": 0, "add": 1, "sub": 2}


# ---------------------------------------------------------------------------
# Plain versions (int64 limb arithmetic)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _limbs_np(value: int, L: int) -> np.ndarray:
    return int_to_limbs(value, L).astype(np.int64)


def limbs_const(value: int, L: int, device) -> torch.Tensor:
    return torch.from_numpy(_limbs_np(value, L)).to(device)


def normalize(cols: torch.Tensor):
    """Signed int64 columns (base 2^16) -> (limbs [..., L], carry [...]).

    The carry is the signed value at position L (negative when the
    columns sum to a negative number).  Carries move up one column per
    round, all columns at once, until none is left: each round keeps the
    value, and the limbs in [0, 2^16) with their carry are its only such
    form, so the result is that of a serial carry chain in a few rounds
    (a chain of 0xFFFF limbs takes one round per limb)."""
    x = cols.movedim(-1, 0).clone()
    top = torch.zeros(cols.shape[:-1], dtype=torch.int64, device=cols.device)
    while True:
        hi = x >> LIMB_BITS
        if not bool(hi.any()):
            return x.movedim(0, -1), top
        x &= LIMB_MASK
        x[1:] += hi[:-1]
        top += hi[-1]


def cond_sub_p(spec: FieldSpec, limbs: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """limbs + extra * 2^(16L) < 2p  ->  canonical limbs (int64)."""
    diff, borrow = normalize(limbs - limbs_const(spec.modulus, spec.num_limbs, limbs.device))
    take = (extra > 0) | (borrow >= 0)
    return torch.where(take[..., None], diff, limbs)


def _to64(a: torch.Tensor, b: torch.Tensor):
    a, b = torch.broadcast_tensors(a, b)
    return a.to(torch.int64), b.to(torch.int64)


def add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _to64(a, b)
    limbs, carry = normalize(a + b)
    return cond_sub_p(spec, limbs, carry).to(torch.int32)


def sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _to64(a, b)
    limbs, borrow = normalize(a - b)
    p = limbs_const(spec.modulus, spec.num_limbs, a.device)
    limbs, _ = normalize(limbs + p * (borrow < 0)[..., None])
    return limbs.to(torch.int32)


def mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery a*b*R^-1 mod p on 16-bit limbs with int64 columns.

    The product's 2L-1 columns (each < L * 2^32) are summed row by row of
    a (one multiply-add of all of b's limbs per row); then REDC step i
    adds m*p (each product < 2^32) at column offset i and carries column i
    up, so no column passes 2L * 2^32 + carries < 2^39 (and t_i * n0 <
    2^55); the result occupies columns L..2L and is below 2p.  The limb
    axis is kept first so that each step's rows are views."""
    a, b = _to64(a, b)
    L = spec.num_limbs
    batch = a.shape[:-1]
    p = limbs_const(spec.modulus, L, a.device).reshape((L,) + (1,) * len(batch))
    a_rows, b_rows = a.movedim(-1, 0), b.movedim(-1, 0).contiguous()  # [L, ...]
    t = torch.zeros((2 * L + 1,) + batch, dtype=torch.int64, device=a.device)
    for i in range(L):
        t[i : i + L].addcmul_(b_rows, a_rows[i])
    for i in range(L):
        m = (t[i] * spec.n0inv) & LIMB_MASK
        t[i : i + L].addcmul_(p, m)
        t[i + 1] += t[i] >> LIMB_BITS
    limbs, carry = normalize(t[L:].movedim(0, -1))
    return cond_sub_p(spec, limbs[..., :L], limbs[..., L] + (carry << LIMB_BITS)).to(torch.int32)


def mul_cios16_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor,
                     limb_dim: int = -1) -> torch.Tensor:
    """Montgomery a*b*R^-1 mod p by the unrolled 16-bit CIOS of the JAX
    package's ``scripts/exp_fieldmul.py`` (its formulation B), one limb row
    at a time on ``int64``; the limbs lie along ``limb_dim``.  Every partial
    product is split into its 16-bit halves, so no running word passes
    2^23; the result is below 2p before one conditional subtract."""
    L = spec.num_limbs
    p = int_to_limbs(spec.modulus, L)
    a = a.movedim(limb_dim, 0).to(torch.int64)
    b = b.movedim(limb_dim, 0).to(torch.int64)
    zero = torch.zeros(a.shape[1:], dtype=torch.int64, device=a.device)
    t = [zero] * (L + 1)
    for i in range(L):
        for j in range(L):  # t += a_i * b
            prod = a[i] * b[j]
            t[j] = t[j] + (prod & LIMB_MASK)
            t[j + 1] = t[j + 1] + (prod >> LIMB_BITS)
        m = ((t[0] & LIMB_MASK) * spec.n0inv) & LIMB_MASK
        for j in range(L):  # t += m * p
            mp = m * int(p[j])
            t[j] = t[j] + (mp & LIMB_MASK)
            t[j + 1] = t[j + 1] + (mp >> LIMB_BITS)
        carry = t[0] >> LIMB_BITS
        t = t[1:] + [zero]
        t[0] = t[0] + carry
    limbs, c = [], zero
    for j in range(L):  # carry propagate
        s = t[j] + c
        limbs.append(s & LIMB_MASK)
        c = s >> LIMB_BITS
    c = c + t[L]
    diff, borrow = [], zero
    for j in range(L):  # subtract p if the value is >= p
        d = limbs[j] - int(p[j]) - borrow
        borrow = (d < 0).to(torch.int64)
        diff.append(d & LIMB_MASK)
    take = (c > 0) | (borrow == 0)
    out = torch.where(take, torch.stack(diff), torch.stack(limbs))
    return out.movedim(0, limb_dim).to(torch.int32)


def mul_limb_major_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mul_limb_major``: [16, M] operands."""
    return mul_cios16_plain(spec, a, b, limb_dim=0)


def mul_tiled_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mul_tiled``: [G, 16, 8, 512] operands."""
    return mul_cios16_plain(spec, a, b, limb_dim=1)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"sczk_fr_binary": [_I, _I, _VP, _VP, _VP, _I, _I, _I, _VP, _VP],
               "sczk_fr_attrs": [_I, _I, _VP],
               "sczk_fr_mul_strided": [_I, _VP, _VP, _VP, _I, _VP, _VP],
               "sczk_fr_strided_attrs": [_I, _VP]}
TILE_SHAPE = (8, 512)
TILE = TILE_SHAPE[0] * TILE_SHAPE[1]  # elements of one tile of the tiled layout
# the strided products: layout number in fr.cu, and the multiple of
# elements the kernel takes
_LAYOUTS = {"mul_limb_major": (0, 1024), "mul_tiled": (1, TILE)}


@functools.lru_cache(maxsize=None)
def field_consts(spec: FieldSpec) -> np.ndarray:
    """Host array the kernels take: modulus as 32-bit words, then n0."""
    words = [(spec.modulus >> (32 * k)) & 0xFFFFFFFF for k in range(spec.num_words)]
    return np.array(words + [spec.n0inv32], dtype=np.uint32)


def kernel_operand(x: torch.Tensor, shape: torch.Size):
    """(contiguous, 16-byte aligned tensor, period in elements) for a kernel
    operand broadcast to ``shape``.

    An operand whose non-unit shape is a trailing block of ``shape`` (a
    constant, a twiddle table) is passed as is and read at ``i % period``;
    any other broadcast is materialised."""
    dims = list(x.shape)
    while len(dims) > 1 and dims[0] == 1:
        dims.pop(0)
    if tuple(dims) != tuple(shape[len(shape) - len(dims):]):
        x = x.expand(shape)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, x.numel() // shape[-1]


def _check_cuda(spec: FieldSpec, *xs: torch.Tensor):
    for x in xs:
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise TypeError(f"kernel operands must be CUDA int32 tensors, got {x.device} {x.dtype}")
        if x.shape[-1] != spec.num_limbs:
            raise ValueError(f"limb axis {x.shape[-1]} != {spec.num_limbs} for {spec.name}")


def _launch(wrapper, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_cuda(spec, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    m = shape.numel() // shape[-1]
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if m == 0:
        return out
    if m >= 2**31:
        raise ValueError(f"{m} elements exceed one launch")
    a, pa = kernel_operand(a, shape)
    b, pb = kernel_operand(b, shape)
    lib = cuda_build.library("fr", _SIGNATURES)
    consts = field_consts(spec)
    err = lib.sczk_fr_binary(
        _OPS[wrapper.__name__], spec.num_words, a.data_ptr(), b.data_ptr(), out.data_ptr(),
        m, pa, pb, consts.ctypes.data, torch.cuda.current_stream(a.device).cuda_stream,
    )
    wrapper.launches += 1
    cuda_build.check(err, f"fr {wrapper.__name__}")
    return out


def _on_cpu(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.device.type == "cpu" and b.device.type == "cpu"


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p: kernel on CUDA, plain on the CPU."""
    return mul_plain(spec, a, b) if _on_cpu(a, b) else _launch(mul, spec, a, b)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p: kernel on CUDA, plain on the CPU."""
    return add_plain(spec, a, b) if _on_cpu(a, b) else _launch(add, spec, a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p: kernel on CUDA, plain on the CPU."""
    return sub_plain(spec, a, b) if _on_cpu(a, b) else _launch(sub, spec, a, b)


def _strided_elements(wrapper, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements M of a layout operand pair; raises on a shape, type or
    field the kernel does not take."""
    name = wrapper.__name__
    if spec.num_words != 8 or spec.num_limbs != 16:
        raise ValueError(f"{name} takes the 16-limb fields, not {spec.name}")
    if a.shape != b.shape:
        raise ValueError(f"{name}: operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if name == "mul_limb_major":
        ok = a.dim() == 2 and a.shape[0] == 16
        M = a.shape[1] if ok else 0
    else:
        ok = a.dim() == 4 and tuple(a.shape[1:]) == (16,) + TILE_SHAPE
        M = a.shape[0] * TILE if ok else 0
    row = _LAYOUTS[name][1]
    if not ok or M == 0 or M % row:
        want = "[16, M]" if name == "mul_limb_major" else "[G, 16, 8, 512]"
        raise ValueError(f"{name} takes int32 {want} with M a positive multiple of {row}, "
                         f"got {tuple(a.shape)}")
    return M


def _launch_strided(wrapper, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    for x in (a, b):
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise TypeError(f"kernel operands must be CUDA int32 tensors, got {x.device} {x.dtype}")
    M = _strided_elements(wrapper, spec, a, b)
    if M >= 2**31:
        raise ValueError(f"{M} elements exceed one launch")
    a, b = (x.contiguous() for x in (a, b))
    a, b = (x.clone() if x.data_ptr() % 16 else x for x in (a, b))
    out = torch.empty_like(a)
    lib = cuda_build.library("fr", _SIGNATURES)
    err = lib.sczk_fr_mul_strided(_LAYOUTS[wrapper.__name__][0], a.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), M, field_consts(spec).ctypes.data,
                                  torch.cuda.current_stream(a.device).cuda_stream)
    wrapper.launches += 1
    cuda_build.check(err, f"fr {wrapper.__name__}")
    return out


def mul_limb_major(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fr Montgomery product on limb-major int32 [16, M] (M a multiple of
    1,024): the kernel on CUDA, ``mul_limb_major_plain`` on the CPU."""
    if _on_cpu(a, b):
        _strided_elements(mul_limb_major, spec, a, b)
        return mul_limb_major_plain(spec, a, b)
    return _launch_strided(mul_limb_major, spec, a, b)


def mul_tiled(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fr Montgomery product on tiled int32 [G, 16, 8, 512] (4,096 elements
    a tile): the kernel on CUDA, ``mul_tiled_plain`` on the CPU."""
    if _on_cpu(a, b):
        _strided_elements(mul_tiled, spec, a, b)
        return mul_tiled_plain(spec, a, b)
    return _launch_strided(mul_tiled, spec, a, b)


def attributes(spec: FieldSpec, op: str) -> dict:
    """Registers and spill (local) bytes per thread of ``op``'s kernel for
    ``spec``'s width (``mul``, ``add``, ``sub``, or a strided product),
    from the card."""
    out = np.zeros(2, dtype=np.int32)
    lib = cuda_build.library("fr", _SIGNATURES)
    if op in _LAYOUTS:
        err = lib.sczk_fr_strided_attrs(_LAYOUTS[op][0], out.ctypes.data)
    else:
        err = lib.sczk_fr_attrs(_OPS[op], spec.num_words, out.ctypes.data)
    cuda_build.check(err, f"fr attributes of {op}")
    return {"registers": int(out[0]), "spill_bytes": int(out[1])}


mul.launches = add.launches = sub.launches = 0
mul_limb_major.launches = mul_tiled.launches = 0
