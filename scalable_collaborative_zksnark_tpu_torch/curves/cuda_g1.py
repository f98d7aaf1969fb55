"""G1 point kernels: CUDA wrappers and their plain PyTorch versions.

Replaces ``curves/pallas_g1.py``: ``_add_kernel`` (``add``, ``add_mixed``)
and ``_double_kernel`` behind ``point_op``; ``_add_masked_kernel``
(``add_masked``) and ``_add_reset_kernel`` (``add_reset``);
``_add_reset_lazy_kernel``
with the scan and repair around it in ``primitives/msm.py``
(``accumulate``); ``_scalar_mul_kernel`` (``scalar_mul``);
``_horner_kernel`` (``horner``); ``_bucket_serial_kernel``
(``bucket_serial``).  The kernels are ``csrc/g1.cu`` on the group law of
``csrc/g1.cuh``; see those files for the design and what bounds it.

A point is a tuple ``(x, y, z)`` of ``int32 [..., 24]`` Fq Montgomery
limbs (Jacobian; z = 0 is infinity, written (0, 1, 0)).  A CPU tensor
goes through the plain version (``*_plain``), a CUDA tensor through the
kernel; a failed build or launch raises.  Each wrapper counts its kernel
launches in ``.launches``.

The plain versions run the formulas of the JAX package's ``Curve.add``,
``add_mixed`` and ``double`` on the plain ``int64`` field ops of
``fields/cuda_fr.py``.  Products that do not depend on each other go
through one call (``_mul``), and the doubling of a complete add is
computed only when a lane needs it; neither changes a value.  They are
the reference the tests and ``chip_smoke.py`` hold the kernels to, and
nothing on the card's path calls them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build
from ..fields import cuda_fr
from ..fields.config import FieldSpec

SENTINEL = 0xFFFFFFFF  # key of the accumulate's padding entries (msm.py)
_OPS = {"add": 0, "add_mixed": 1, "double": 2}
_MASKED_OPS = {"add_masked": 0, "add_reset": 1}

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sczk_g1_point_op": [_I] + [_VP] * 9 + [_I, _VP, _VP],
    "sczk_g1_masked_op": [_I] + [_VP] * 10 + [_I, _VP, _VP],
    "sczk_g1_accumulate": [_VP, _VP, _VP, _LL, _VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    "sczk_g1_scalar_mul": [_VP, _VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP],
    "sczk_g1_horner": [_VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP],
    "sczk_g1_bucket_serial": [_VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP],
    "sczk_g1_attrs": [_I, _VP],
    "sczk_fq_mul_chain": [_VP, _I, _VP, _VP, _VP],
    "sczk_imad_chain": [_VP, _I, _VP, _VP],
}
ATTR_KERNELS = ("add", "add_mixed", "double", "accumulate", "scalar_mul", "horner",
                "bucket_serial", "add_masked", "add_reset")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def infinity(spec: FieldSpec, shape, device) -> tuple:
    """(0, 1, 0) in Montgomery form, ``shape`` points (contiguous)."""
    one = torch.from_numpy(spec.r_limbs.astype(np.int32)).to(device)
    zero = torch.zeros(tuple(shape) + (spec.num_limbs,), dtype=torch.int32, device=device)
    return zero, one.expand_as(zero).contiguous(), zero.clone()


def select(cond: torch.Tensor, a: tuple, b: tuple) -> tuple:
    """cond ? a : b per point (cond shaped like the batch)."""
    c = cond[..., None]
    return tuple(torch.where(c, u, v) for u, v in zip(a, b))


def _mul(spec: FieldSpec, *pairs):
    """Products of independent same-shape pairs in one plain call."""
    a = torch.stack([x for x, _ in pairs])
    b = torch.stack([y for _, y in pairs])
    return cuda_fr.mul_plain(spec, a, b).unbind(0)


def double_plain(spec: FieldSpec, pt: tuple) -> tuple:
    """dbl-2009-l (``Curve.double``); doubling infinity keeps z = 0."""
    add = functools.partial(cuda_fr.add_plain, spec)
    sub = functools.partial(cuda_fr.sub_plain, spec)
    X, Y, Z = pt
    A, B, YZ = _mul(spec, (X, X), (Y, Y), (Y, Z))
    t = add(X, B)
    C, t = _mul(spec, (B, B), (t, t))
    D = sub(sub(t, A), C)
    D = add(D, D)
    E = add(add(A, A), A)
    (G,) = _mul(spec, (E, E))
    X3 = sub(G, add(D, D))
    C8 = add(C, C)
    C8 = add(C8, C8)
    C8 = add(C8, C8)
    (Y3,) = _mul(spec, (E, sub(D, X3)))
    Y3 = sub(Y3, C8)
    Z3 = add(YZ, YZ)
    Z3 = torch.where(_is_zero(Z)[..., None], torch.zeros_like(Z3), Z3)
    return X3, Y3, Z3


def add_plain(spec: FieldSpec, p1: tuple, p2: tuple, mixed: bool = False):
    """Complete add-2007-bl (madd-2007-bl with ``mixed``: z2 in {0, 1}),
    the selects of ``Curve.add``.  Returns (sum, lanes that doubled)."""
    add = functools.partial(cuda_fr.add_plain, spec)
    sub = functools.partial(cuda_fr.sub_plain, spec)
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if mixed:
        Z1Z1, Y2Z1 = _mul(spec, (Z1, Z1), (Y2, Z1))
        U1, S1 = X1, Y1
        U2, S2 = _mul(spec, (X2, Z1Z1), (Y2Z1, Z1Z1))
    else:
        ZS = add(Z1, Z2)
        Z1Z1, Z2Z2, Y1Z2, Y2Z1, ZS2 = _mul(spec, (Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (ZS, ZS))
        U1, S1, U2, S2 = _mul(spec, (X1, Z2Z2), (Y1Z2, Z2Z2), (X2, Z1Z1), (Y2Z1, Z1Z1))
    H = sub(U2, U1)
    r = sub(S2, S1)
    if mixed:
        HH, Z3 = _mul(spec, (H, H), (add(Z1, Z1), H))
    else:
        HH, Z3 = _mul(spec, (H, H), (sub(sub(ZS2, Z1Z1), Z2Z2), H))
    I = add(HH, HH)
    I = add(I, I)
    r2 = add(r, r)
    J, V, R2 = _mul(spec, (H, I), (U1, I), (r2, r2))
    X3 = sub(sub(R2, J), add(V, V))
    T, SJ = _mul(spec, (r2, sub(V, X3)), (S1, J))
    Y3 = sub(T, add(SJ, SJ))
    inf1, inf2 = _is_zero(Z1), _is_zero(Z2)
    same_x = _is_zero(H) & ~(inf1 | inf2)
    is_dbl = same_x & _is_zero(r)
    out = (X3, Y3, Z3)
    if bool(is_dbl.any()):
        out = select(is_dbl, double_plain(spec, p1), out)
    out = select(same_x & ~is_dbl, infinity(spec, X3.shape[:-1], X3.device), out)
    out = select(inf2, p1, out)
    return select(inf1, p2, out), is_dbl


def masked_plain(spec: FieldSpec, p1: tuple, p2: tuple, mask: torch.Tensor,
                 keep_first: bool) -> tuple:
    """mask ? p1 + p2 (mixed) : (p1 if ``keep_first`` else p2), the add
    computed on the masked lanes only (``Curve.add_mixed_masked`` /
    ``add_mixed_reset``)."""
    p1, p2, mask = _broadcast_masked(p1, p2, mask)
    out = tuple(a.clone(memory_format=torch.contiguous_format)
                for a in (p1 if keep_first else p2))
    idx = mask.nonzero(as_tuple=True)
    if idx[0].numel():
        summed = add_plain(spec, tuple(a[idx] for a in p1), tuple(a[idx] for a in p2),
                           mixed=True)[0]
        for o, s in zip(out, summed):
            o[idx] = s
    return out


def neg_y_plain(spec: FieldSpec, y: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """y -> p - y where ``neg`` (``Field.neg``: 0 - y)."""
    return torch.where(neg[..., None], cuda_fr.sub_plain(spec, torch.zeros_like(y), y), y)


def accumulate_plain(spec: FieldSpec, keys: torch.Tensor, pid: torch.Tensor, neg: torch.Tensor,
                     bases: tuple, T: int, steps: int):
    """The dense MSM's per-lane scan (``msm.py`` ``_dense_bucket_sums``).

    Entry e of the key-sorted list is the point ``bases[pid[e]]``, negated
    where ``neg[e]``; the list is padded to T*steps entries with key
    ``SENTINEL`` and infinity, and lane t owns entries [t*steps,
    (t+1)*steps).  Returns (scanned [steps, T] points, where step s holds
    ``(key == previous key) ? acc + P : P``, and the number of steps that
    doubled)."""
    E = keys.shape[0]
    pad = T * steps - E
    pts = tuple(b[pid] for b in bases)
    pts = (pts[0], neg_y_plain(spec, pts[1], neg), pts[2])
    keys = torch.cat([keys, torch.full((pad,), SENTINEL, dtype=keys.dtype, device=keys.device)])
    pts = tuple(torch.cat([a, f]) for a, f in zip(pts, infinity(spec, (pad,), keys.device)))
    keys = keys.reshape(T, steps).T
    pts = tuple(a.reshape(T, steps, -1).transpose(0, 1) for a in pts)
    acc = infinity(spec, (T,), keys.device)
    prev = torch.full((T,), SENTINEL, dtype=keys.dtype, device=keys.device)
    out, doubled = [], 0
    for s in range(steps):
        p = tuple(a[s] for a in pts)
        same = keys[s] == prev
        summed, dbl = add_plain(spec, acc, p, mixed=True)
        acc = select(same, summed, p)
        doubled += int((same & dbl).sum())
        prev = keys[s]
        out.append(acc)
    return tuple(torch.stack([o[j] for o in out]) for j in range(3)), doubled


def scalar_mul_plain(spec: FieldSpec, pt: tuple, scalars: torch.Tensor) -> tuple:
    """MSB-first double-and-add over standard-form 16-bit scalar limbs
    (``Curve.scalar_mul``); ``pt`` and ``scalars`` share their batch shape."""
    shape = pt[0].shape[:-1]
    pt = tuple(a.reshape(-1, a.shape[-1]) for a in pt)
    w_all = scalars.reshape(-1, scalars.shape[-1])
    acc = infinity(spec, (pt[0].shape[0],), pt[0].device)
    for limb in range(scalars.shape[-1] - 1, -1, -1):
        w = w_all[:, limb]
        for b in range(15, -1, -1):
            acc = double_plain(spec, acc)
            idx = (((w >> b) & 1) > 0).nonzero(as_tuple=True)  # lanes that add, as the kernel
            if idx[0].numel():
                summed = add_plain(spec, tuple(a[idx] for a in acc), tuple(a[idx] for a in pt))[0]
                for a, s in zip(acc, summed):
                    a[idx] = s
    return tuple(a.reshape(shape + a.shape[-1:]) for a in acc)


def horner_plain(spec: FieldSpec, totals: tuple, c: int) -> tuple:
    """sum_w 2^(c*w) T_w over totals [W, C] (window 0 least significant),
    MSB window first: c doublings, then one general add."""
    acc = infinity(spec, totals[0].shape[1:-1], totals[0].device)
    for w in range(totals[0].shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = double_plain(spec, acc)
        acc = add_plain(spec, acc, tuple(a[w] for a in totals))[0]
    return acc


def bucket_serial_plain(spec: FieldSpec, buckets: tuple) -> tuple:
    """sum_{k>=1} k*B_k over buckets [K, M] (k ascending) by the running
    suffix: acc = B_{K-1}, total = acc; then for k = K-2 .. 1,
    acc += B_k, total += acc."""
    K = buckets[0].shape[0]
    acc = tuple(a[K - 1] for a in buckets)
    total = acc
    for k in range(K - 2, 0, -1):
        acc = add_plain(spec, acc, tuple(a[k] for a in buckets))[0]
        total = add_plain(spec, total, acc)[0]
    return total


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def g1_consts(spec: FieldSpec) -> np.ndarray:
    """Host array the kernels take: modulus words, n0, Montgomery 1 words."""
    words = lambda v: [(v >> (32 * k)) & 0xFFFFFFFF for k in range(spec.num_words)]  # noqa: E731
    return np.array(words(spec.modulus) + [spec.n0inv32] + words(spec.r), dtype=np.uint32)


def _check(spec: FieldSpec, *xs: torch.Tensor):
    if spec.num_words != 12:
        raise ValueError(f"the G1 kernels take 381-bit base fields, got {spec.name}")
    for x in xs:
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise TypeError(f"kernel operands must be CUDA int32 tensors, got {x.device} {x.dtype}")


def _operand(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` broadcast to ``shape``, contiguous and 16-byte aligned."""
    x = x.expand(shape).contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _ptrs(pt: tuple):
    return [a.data_ptr() for a in pt]


def _empty(spec: FieldSpec, shape, device) -> tuple:
    return tuple(torch.empty(tuple(shape) + (spec.num_limbs,), dtype=torch.int32, device=device)
                 for _ in range(3))


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _lib():
    return cuda_build.library("g1", _SIGNATURES)


def _launch_point_op(wrapper, spec: FieldSpec, p1: tuple, p2: tuple) -> tuple:
    coords = list(p1) + list(p2 or ())
    _check(spec, *coords)
    shape = torch.broadcast_shapes(*(a.shape for a in coords))
    if shape[-1] != spec.num_limbs:
        raise ValueError(f"limb axis {shape[-1]} != {spec.num_limbs}")
    m = shape.numel() // shape[-1]
    out = _empty(spec, shape[:-1], coords[0].device)
    if m == 0:
        return out
    a = [_operand(x, shape) for x in p1]
    b = [_operand(x, shape) for x in p2] if p2 is not None else a
    err = _lib().sczk_g1_point_op(_OPS[wrapper.__name__], *_ptrs(a), *_ptrs(b), *_ptrs(out), m,
                                  g1_consts(spec).ctypes.data, _stream(a[0]))
    wrapper.launches += 1
    cuda_build.check(err, f"g1 {wrapper.__name__}")
    return out


def _on_cpu(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _broadcast(*pts: tuple) -> list:
    """Points broadcast to one batch shape (materialised, for the plain ops)."""
    shape = torch.broadcast_shapes(*(a.shape for pt in pts for a in pt))
    return [tuple(a.expand(shape) for a in pt) for pt in pts]


def _broadcast_masked(p1: tuple, p2: tuple, mask: torch.Tensor):
    """Two point operands and a per-point mask broadcast to one batch shape."""
    shape = torch.broadcast_shapes(*(a.shape for a in p1 + p2), mask.shape + p1[0].shape[-1:])
    return (tuple(a.expand(shape) for a in p1), tuple(a.expand(shape) for a in p2),
            mask.expand(shape[:-1]))


def _masked_op(wrapper, spec: FieldSpec, p1: tuple, p2: tuple, mask: torch.Tensor) -> tuple:
    if _on_cpu(*p1, *p2, mask):
        return wrapper.plain(spec, p1, p2, mask)
    _check(spec, *p1, *p2)
    if mask.dtype != torch.bool or mask.device != p1[0].device:
        raise TypeError(f"the mask must be a bool tensor on {p1[0].device}, got "
                        f"{mask.device} {mask.dtype}")
    p1, p2, mask = _broadcast_masked(p1, p2, mask)
    shape = p1[0].shape
    if shape[-1] != spec.num_limbs:
        raise ValueError(f"limb axis {shape[-1]} != {spec.num_limbs}")
    m = shape.numel() // shape[-1]
    out = _empty(spec, shape[:-1], mask.device)
    if m == 0:
        return out
    a = [_operand(x, shape) for x in p1]
    b = [_operand(x, shape) for x in p2]
    mk = mask.contiguous()
    err = _lib().sczk_g1_masked_op(_MASKED_OPS[wrapper.__name__], *_ptrs(a), *_ptrs(b),
                                   mk.data_ptr(), *_ptrs(out), m, g1_consts(spec).ctypes.data,
                                   _stream(mk))
    wrapper.launches += 1
    cuda_build.check(err, f"g1 {wrapper.__name__}")
    return out


def add_masked(spec: FieldSpec, p1: tuple, p2: tuple, valid: torch.Tensor) -> tuple:
    """valid ? p1 + p2 : p1 per point, p2 affine or infinity (the non-dense
    MSM's bucket step): kernel on CUDA, plain on the CPU."""
    return _masked_op(add_masked, spec, p1, p2, valid)


def add_reset(spec: FieldSpec, p1: tuple, p2: tuple, same: torch.Tensor) -> tuple:
    """same ? p1 + p2 : p2 per point, p2 affine or infinity: kernel on
    CUDA, plain on the CPU."""
    return _masked_op(add_reset, spec, p1, p2, same)


def add(spec: FieldSpec, p1: tuple, p2: tuple) -> tuple:
    """Complete general add p1 + p2 (operands broadcast): kernel on CUDA,
    plain on the CPU."""
    if _on_cpu(*p1, *p2):
        return add.plain(spec, p1, p2)
    return _launch_point_op(add, spec, p1, p2)


def add_mixed(spec: FieldSpec, p1: tuple, p2: tuple) -> tuple:
    """Complete mixed add, p2 with z in {0, 1}: kernel on CUDA, plain on the CPU."""
    if _on_cpu(*p1, *p2):
        return add_mixed.plain(spec, p1, p2)
    return _launch_point_op(add_mixed, spec, p1, p2)


def double(spec: FieldSpec, pt: tuple) -> tuple:
    """2 * pt: kernel on CUDA, plain on the CPU."""
    if _on_cpu(*pt):
        return double_plain(spec, pt)
    return _launch_point_op(double, spec, pt, None)


def accumulate(spec: FieldSpec, keys: torch.Tensor, pid: torch.Tensor, neg: torch.Tensor,
               bases: tuple, T: int, steps: int):
    """The dense MSM's lane scan (see ``accumulate_plain``): one launch on
    CUDA, the plain version on the CPU.  Returns (scanned, doubled steps);
    ``accumulate.repaired`` sums the doubled steps over calls."""
    if _on_cpu(keys, *bases):
        scanned, doubled = accumulate.plain(spec, keys, pid, neg, bases, T, steps)
    else:
        scanned, doubled = _launch_accumulate(spec, keys, pid, neg, bases, T, steps)
    accumulate.repaired += doubled
    return scanned, doubled


def _launch_accumulate(spec, keys, pid, neg, bases, T, steps):
    _check(spec, *bases)
    E = keys.shape[0]
    if keys.dtype != torch.int64 or pid.dtype != torch.int64 or neg.dtype != torch.bool:
        raise TypeError("keys and pid must be int64, neg bool")
    if pid.shape != (E,) or neg.shape != (E,) or not 0 <= E <= T * steps:
        raise ValueError(f"{E} entries do not fit {T} lanes of {steps} steps")
    for x in (keys, pid, neg):
        if x.device != bases[0].device:
            raise TypeError(f"operands on {x.device} and {bases[0].device}")
    n = bases[0].shape[0]
    base = [_operand(a, (n, spec.num_limbs)) for a in bases]
    keys, pid, neg = keys.contiguous(), pid.contiguous(), neg.contiguous()
    out = _empty(spec, (steps, T), keys.device)
    repaired = torch.zeros(1, dtype=torch.int32, device=keys.device)
    err = _lib().sczk_g1_accumulate(keys.data_ptr(), pid.data_ptr(), neg.data_ptr(), E,
                                    *_ptrs(base), T, steps, *_ptrs(out), repaired.data_ptr(),
                                    g1_consts(spec).ctypes.data, _stream(keys))
    accumulate.launches += 1
    cuda_build.check(err, "g1 accumulate")
    return out, int(repaired.item())


def scalar_mul(spec: FieldSpec, pt: tuple, scalars: torch.Tensor) -> tuple:
    """pt * scalar per lane (standard-form 16-bit limbs [..., n]; batch
    shapes broadcast): kernel on CUDA, plain on the CPU."""
    pt, scalars = _broadcast_scalars(pt, scalars)
    if _on_cpu(*pt, scalars):
        return scalar_mul_plain(spec, pt, scalars)
    shape = scalars.shape[:-1]
    _check(spec, *pt, scalars)
    m = shape.numel()
    out = _empty(spec, shape, scalars.device)
    if m == 0:
        return out
    n_limbs = scalars.shape[-1]
    P = [_operand(a, a.shape) for a in pt]
    sc = _operand(scalars, scalars.shape)
    err = _lib().sczk_g1_scalar_mul(*_ptrs(P), sc.data_ptr(), n_limbs, m, *_ptrs(out),
                                    g1_consts(spec).ctypes.data, _stream(sc))
    scalar_mul.launches += 1
    cuda_build.check(err, "g1 scalar_mul")
    return out


def _broadcast_scalars(pt: tuple, scalars: torch.Tensor):
    shape = torch.broadcast_shapes(pt[0].shape[:-1], scalars.shape[:-1])
    return (tuple(a.expand(shape + a.shape[-1:]) for a in pt),
            scalars.expand(shape + scalars.shape[-1:]))


def horner(spec: FieldSpec, totals: tuple, c: int) -> tuple:
    """sum_w 2^(c*w) T_w over totals [W, C] -> [C]: kernel on CUDA, plain on the CPU."""
    if _on_cpu(*totals):
        return horner_plain(spec, totals, c)
    _check(spec, *totals)
    W, C = totals[0].shape[0], totals[0].shape[1]
    tot = [_operand(a, a.shape) for a in totals]
    out = _empty(spec, (C,), tot[0].device)
    err = _lib().sczk_g1_horner(*_ptrs(tot), W, C, c, *_ptrs(out), g1_consts(spec).ctypes.data,
                                _stream(tot[0]))
    horner.launches += 1
    cuda_build.check(err, "g1 horner")
    return out


def bucket_serial(spec: FieldSpec, buckets: tuple) -> tuple:
    """sum_{k>=1} k*B_k over buckets [K, M] -> [M]: kernel on CUDA, plain on the CPU."""
    if _on_cpu(*buckets):
        return bucket_serial_plain(spec, buckets)
    _check(spec, *buckets)
    K, M = buckets[0].shape[0], buckets[0].shape[1]
    b = [_operand(a, a.shape) for a in buckets]
    out = _empty(spec, (M,), b[0].device)
    err = _lib().sczk_g1_bucket_serial(*_ptrs(b), K, M, *_ptrs(out), g1_consts(spec).ctypes.data,
                                       _stream(b[0]))
    bucket_serial.launches += 1
    cuda_build.check(err, "g1 bucket_serial")
    return out


def fq_mul_chain(spec: FieldSpec, xy: torch.Tensor, n: int) -> torch.Tensor:
    """x * y^n * R^-n by n dependent Montgomery products in one thread, for
    ``xy`` [2, 24] on the card: what one Fq product of csrc/fr.cuh costs in
    a single thread (a diagnostic; the chain bounds use ``imad_chain``)."""
    _check(spec, xy)
    xy = _operand(xy, xy.shape)
    out = torch.empty(spec.num_limbs, dtype=torch.int32, device=xy.device)
    cuda_build.check(_lib().sczk_fq_mul_chain(xy.data_ptr(), n, out.data_ptr(),
                                              g1_consts(spec).ctypes.data, _stream(xy)),
                     "fq mul chain")
    return out


def imad_chain(xy: torch.Tensor, n: int) -> torch.Tensor:
    """c = lo(c) * y + c mod 2^64, n times from c = x, in one thread, for
    ``xy`` int32 [2] on the card (the bits of uint32 x, y): a probe of one
    dependent 32x32->64 multiply-add's latency.  Returns c's bits, int64 [1]."""
    if xy.device.type != "cuda" or xy.dtype != torch.int32 or xy.shape != (2,):
        raise TypeError(f"imad_chain takes a CUDA int32 [2], got {xy.device} {xy.dtype} "
                        f"{tuple(xy.shape)}")
    xy = xy.contiguous()
    out = torch.empty(1, dtype=torch.int64, device=xy.device)
    cuda_build.check(_lib().sczk_imad_chain(xy.data_ptr(), n, out.data_ptr(), _stream(xy)),
                     "imad chain")
    return out


def attributes(name: str) -> dict:
    """Registers and spill (local) bytes per thread of a kernel, from the card."""
    out = np.zeros(2, dtype=np.int32)
    cuda_build.check(_lib().sczk_g1_attrs(ATTR_KERNELS.index(name), out.ctypes.data),
                     f"g1 attributes of {name}")
    return {"registers": int(out[0]), "spill_bytes": int(out[1])}


# The plain version of each wrapper, with the wrapper's arguments and result.
add.plain = lambda spec, p1, p2: add_plain(spec, *_broadcast(p1, p2))[0]  # noqa: E731
add_mixed.plain = lambda spec, p1, p2: add_plain(  # noqa: E731
    spec, *_broadcast(p1, p2), mixed=True)[0]
double.plain = double_plain
add_masked.plain = lambda spec, p1, p2, valid: masked_plain(  # noqa: E731
    spec, p1, p2, valid, keep_first=True)
add_reset.plain = lambda spec, p1, p2, same: masked_plain(  # noqa: E731
    spec, p1, p2, same, keep_first=False)
accumulate.plain = accumulate_plain
scalar_mul.plain = lambda spec, pt, scalars: scalar_mul_plain(  # noqa: E731
    spec, *_broadcast_scalars(pt, scalars))
horner.plain = horner_plain
bucket_serial.plain = bucket_serial_plain

add.launches = add_mixed.launches = double.launches = 0
add_masked.launches = add_reset.launches = 0
accumulate.launches = accumulate.repaired = 0
scalar_mul.launches = horner.launches = bucket_serial.launches = 0
