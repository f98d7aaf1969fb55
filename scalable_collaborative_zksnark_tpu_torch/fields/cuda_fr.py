"""Elementwise field kernels: CUDA wrappers and their plain PyTorch versions.

Replaces ``fields/pallas_fr.py`` (``_mul_kernel``, ``_add_kernel``,
``_sub_kernel`` behind ``pallas_fr.binary``).  The kernels are ``csrc/fr.cu`` on the
carry-chain arithmetic of ``csrc/fq_chain.cuh``; see that file for the
design and what bounds it.

Layout at the boundary: ``int32 [..., L]`` 16-bit limbs in Montgomery form
(L = 16 for Fr, 24 for Fq).  Inputs must be canonical (< p); outputs are
canonical.  ``mul``/``add``/``sub`` broadcast their operands as
``torch.broadcast_tensors`` does.  A CPU tensor goes through the plain
version (``*_plain``), a CUDA tensor through the kernel; a failed build or
launch raises.  Each wrapper counts its kernel launches in ``.launches``.
The kernel reads each operand in place through its strides
(``kernel_operands``); ``copies`` counts the operands it had to
materialise instead (a limb axis that is not unit-stride, or more than
``MAX_RANK`` coalesced dims).

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
import math

import numpy as np
import torch

from .. import cuda_build
from ..utils import timer
from .config import LIMB_BITS, LIMB_MASK, FieldSpec, int_to_limbs

_OPS = {"mul": 0, "add": 1, "sub": 2}


# ---------------------------------------------------------------------------
# Plain versions (int64 limb arithmetic)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _limbs_np(value: int, L: int) -> np.ndarray:
    return int_to_limbs(value, L).astype(np.int64)


def limbs_const(value: int, L: int, device) -> torch.Tensor:
    timer.count("sync.upload.limbs_const")
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
        timer.count("sync.normalize")
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
_SIGNATURES = {"sczk_fr_binary": [_I, _I, _VP, _VP, _VP, _I, _VP, _I, _VP, _VP],
               "sczk_fr_attrs": [_I, _I, _I, _VP],
               "sczk_fr_mul_strided": [_I, _VP, _VP, _VP, _I, _VP, _VP],
               "sczk_fr_strided_attrs": [_I, _VP],
               "sczk_fr_empty": [_VP]}
MAX_RANK = 4  # coalesced batch dims a launch takes (csrc/fr.cu kRank)
# outputs from which a launch stages its dense operands in shared memory: the
# smallest size from which a staged launch was no slower than a small one in
# every op of Fr and Fq on an H100 (scripts/chain_bench.py stage_ms, 1 to
# 65,536 outputs; at 192, Fr was 10% slower staged)
STAGE_MIN = 256
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


@functools.lru_cache(maxsize=None)
def _consts_ptr(spec: FieldSpec) -> int:
    return field_consts(spec).ctypes.data  # the cached array outlives every call


def broadcast_shape(sa, sb) -> tuple:
    """The shape two operands of ``sa`` and ``sb`` broadcast to, as
    ``torch.broadcast_shapes`` gives it (a tenth of its host time)."""
    if sa == sb:
        return tuple(sa)
    n = max(len(sa), len(sb))
    sa, sb = (1,) * (n - len(sa)) + tuple(sa), (1,) * (n - len(sb)) + tuple(sb)
    out = []
    for x, y in zip(sa, sb):
        if x != y and 1 not in (x, y):
            raise ValueError(f"shapes {sa} and {sb} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def coalesce(dims, strides: list) -> tuple[list, list]:
    """The batch dims of a contiguous output and each operand's strides
    along them, coalesced as PyTorch's TensorIterator does: dims of size 1
    dropped, and a dim merged into the one outside it where every
    operand's strides allow (the outer stride is the inner one times the
    inner size).  Returns (dims, strides) with at least one dim."""
    out_dims, out_strides = [], [[] for _ in strides]
    for k, n in enumerate(dims):
        if n == 1:
            continue
        if out_dims and all(o[-1] == s[k] * n for o, s in zip(out_strides, strides)):
            out_dims[-1] *= n
            for o, s in zip(out_strides, strides):
                o[-1] = s[k]
        else:
            out_dims.append(n)
            for o, s in zip(out_strides, strides):
                o.append(s[k])
    if not out_dims:
        return [1], [[0] for _ in strides]
    return out_dims, out_strides


def _batch_strides(x: torch.Tensor, shape) -> list:
    """x's strides along the batch dims of ``shape``, 0 where it broadcasts."""
    pad = len(shape) - x.dim()
    sizes, strides = x.shape, x.stride()
    return [0 if k < pad or sizes[k - pad] == 1 else strides[k - pad]
            for k in range(len(shape) - 1)]


def _materialise(x: torch.Tensor, shape) -> torch.Tensor:
    global copies
    copies += 1
    return x.expand(shape).contiguous()


def kernel_operands(shape, *xs: torch.Tensor) -> tuple[list, list]:
    """(dims, [(operand, strides)]) for a launch whose output is the
    contiguous ``shape`` [..., L]: the output's batch dims coalesced
    (``coalesce``), and each operand as it is, read at ``data_ptr()`` plus
    the sum over dims of coordinate times stride int32 slots (0 where it
    broadcasts), its L limbs contiguous.  Transposed views, stepped slices,
    broadcasts in any dim and bases that are not 16-byte aligned are read
    in place.  An operand whose limb axis is not unit-stride, or one that
    leaves more than ``MAX_RANK`` coalesced dims (the operand that keeps
    the most dims on its own goes first), is materialised and counted in
    ``copies``."""
    xs = [x if x.shape[-1] == shape[-1] and x.stride(-1) == 1 else _materialise(x, shape)
          for x in xs]
    while True:
        strides = [_batch_strides(x, shape) for x in xs]
        dims, strides = coalesce(shape[:-1], strides)
        if len(dims) <= MAX_RANK:
            return dims, list(zip(xs, strides))
        own = [len(coalesce(shape[:-1], [_batch_strides(x, shape)])[0]) for x in xs]
        k = own.index(max(own))
        xs[k] = _materialise(xs[k], shape)


def launch_mode(a: torch.Tensor, b: torch.Tensor) -> str:
    """The instance of ``binary_kernel`` a launch on a and b runs, as
    ``csrc/fr.cu``'s ``launch`` picks it: "small" below ``STAGE_MIN``
    outputs where both operands take 16-byte loads (the base 16-byte
    aligned, the stride of every dim of more than one element a multiple
    of 4 slots), else "staged".  For reports; it launches nothing."""
    shape = broadcast_shape(a.shape, b.shape)
    if math.prod(shape[:-1]) >= STAGE_MIN:
        return "staged"
    dims, operands = kernel_operands(shape, a, b)
    vec = all(x.data_ptr() % 16 == 0 and all(s % 4 == 0 for n, s in zip(dims, st) if n > 1)
              for x, st in operands)
    return "small" if vec else "staged"


def _check_cuda(spec: FieldSpec, *xs: torch.Tensor):
    for x in xs:
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise TypeError(f"kernel operands must be CUDA int32 tensors, got {x.device} {x.dtype}")
        if x.shape[-1] != spec.num_limbs:
            raise ValueError(f"limb axis {x.shape[-1]} != {spec.num_limbs} for {spec.name}")


def run_binary(lib, op: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, stream,
               staged: bool | None = None) -> torch.Tensor:
    """One ``sczk_fr_binary`` call of ``lib``: ``op`` of a and b broadcast,
    into a new contiguous tensor; ``staged`` (default: at least
    ``STAGE_MIN`` outputs) stages dense operands through shared memory; a
    launch with an operand that does not take 16-byte loads stages always.
    Checks the C entry's return code and nothing else: ``_launch`` is the
    checked wrapper (the host emulation of the tests calls this with its
    own ``lib``)."""
    shape = broadcast_shape(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    m = math.prod(shape[:-1])
    if m == 0:
        return out
    if m >= 2**31:
        raise ValueError(f"{m} elements exceed one launch")
    dims, ((a, sa), (b, sb)) = kernel_operands(shape, a, b)
    layout = (ctypes.c_longlong * (3 * len(dims)))(*dims, *sa, *sb)
    if staged is None:
        staged = m >= STAGE_MIN
    err = lib.sczk_fr_binary(_OPS[op], spec.num_words, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             len(dims), layout, int(staged), _consts_ptr(spec), stream)
    cuda_build.check(err, f"fr {op}")
    return out


def _launch(wrapper, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_cuda(spec, a, b)
    out = run_binary(cuda_build.library("fr", _SIGNATURES), wrapper.__name__, spec, a, b,
                     torch.cuda.current_stream(a.device).cuda_stream)
    if out.numel():
        wrapper.launches += 1
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


def empty_launch(device) -> None:
    """One launch of a kernel that does nothing, on ``device``'s current
    stream: a probe of the device time every launch costs."""
    lib = cuda_build.library("fr", _SIGNATURES)
    cuda_build.check(lib.sczk_fr_empty(torch.cuda.current_stream(device).cuda_stream),
                     "empty launch")


def attributes(spec: FieldSpec, op: str, staged: bool = False) -> dict:
    """Registers and spill (local) bytes per thread of ``op``'s kernel for
    ``spec``'s width (``mul``, ``add``, ``sub``: a ``staged`` launch or a
    small one; or a strided product),
    from the card."""
    out = np.zeros(2, dtype=np.int32)
    lib = cuda_build.library("fr", _SIGNATURES)
    if op in _LAYOUTS:
        err = lib.sczk_fr_strided_attrs(_LAYOUTS[op][0], out.ctypes.data)
    else:
        err = lib.sczk_fr_attrs(_OPS[op], spec.num_words, int(staged), out.ctypes.data)
    cuda_build.check(err, f"fr attributes of {op}")
    return {"registers": int(out[0]), "spill_bytes": int(out[1])}


mul.launches = add.launches = sub.launches = 0
mul_limb_major.launches = mul_tiled.launches = 0
copies = 0  # operands ``kernel_operands`` materialised
