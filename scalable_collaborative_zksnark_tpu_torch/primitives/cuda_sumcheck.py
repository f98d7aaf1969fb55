"""Fused sumcheck-product fold phase: CUDA wrapper and plain version.

Replaces ``primitives/pallas_sumcheck.py`` ``_phase_kernel`` (via
``product_phase``).  For f, g ``[..., M, L]`` (M = 2^R) it returns the R
rounds' messages (t0, t1, t2) as canonical elements and the folded
finals, exactly as R rounds of the unfused loop in ``sumcheck.py`` would.
The kernel is ``csrc/sumcheck.cu`` (design and bound in its header): at
every M <= 2^13 (every table the prove folds) the whole phase is one
launch, a thread block cluster of K blocks a batch slot with the tables
in shared memory; a larger table first runs ``log2(M / 2^13)`` streaming
head rounds over all SMs, then the cluster kernel.  One ctypes call a
phase, one allocation for the outputs (and one for the head rounds'
tables and partial sums).

A CPU tensor goes through ``product_phase_plain`` (the reference the tests
and ``chip_smoke.py`` hold the kernel to), a CUDA tensor through the
kernel, or it raises; ``product_phase.launches`` counts every launch
(head rounds + 1 a call).  ``fr_mul_cc`` and ``fr_mul_chain`` probe the
carry-chain Fr product the kernel folds with.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build
from ..fields import cuda_fr
from ..fields.config import FieldSpec
from ..fields.fr import Field, column_sum

TAIL_MAX = 1 << 13  # the largest table the cluster kernel folds from its first round
CLUSTER_MAX = 8  # blocks a cluster (portable)

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sczk_product_phase": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _I, _VP, _VP],
    "sczk_phase_scratch_words": [_LL, _I, _I, _VP],
    "sczk_fr_mul_cc": [_VP, _VP, _VP, _I, _VP, _VP],
    "sczk_fr_mul_chain": [_VP, _I, _I, _VP, _VP, _VP],
    "sczk_phase_smem": [_I, _I],
    "sczk_sumcheck_attrs": [_I, _VP],
}


def _fsum(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return column_sum(spec, x, -2, cuda_fr.mul_plain, cuda_fr.add_plain)


def product_phase_plain(spec: FieldSpec, evals_f: torch.Tensor, evals_g: torch.Tensor,
                        challenges: torch.Tensor, start: int):
    """Plain version: log2(M) product rounds with the plain field ops."""
    mul = lambda a, b: cuda_fr.mul_plain(spec, a, b)  # noqa: E731
    add = lambda a, b: cuda_fr.add_plain(spec, a, b)  # noqa: E731
    sub = lambda a, b: cuda_fr.sub_plain(spec, a, b)  # noqa: E731
    cur_f, cur_g = evals_f, evals_g
    msgs = []
    for r in range(evals_f.shape[-2].bit_length() - 1):
        half = cur_f.shape[-2] // 2
        lof, hif = cur_f[..., :half, :], cur_f[..., half:, :]
        log, hig = cur_g[..., :half, :], cur_g[..., half:, :]
        t0 = _fsum(spec, mul(lof, log))
        t1 = _fsum(spec, mul(hif, hig))
        df, dg = sub(hif, lof), sub(hig, log)
        t2 = _fsum(spec, mul(add(hif, df), add(hig, dg)))  # (2hi - lo) products
        msgs.append(torch.stack([t0, t1, t2], dim=-2))
        ch = challenges[start + r]
        cur_f = add(lof, mul(ch, df))
        cur_g = add(log, mul(ch, dg))
    return msgs, cur_f, cur_g


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _lib():
    return cuda_build.library("sumcheck", _SIGNATURES)


def plan(M: int) -> tuple[int, int]:
    """(K, head) for tables of M = 2^R elements: head rounds until the
    table is at most ``TAIL_MAX``, then clusters of K = clamp(M_tail / 128,
    1, 8) blocks (the reasoning is in csrc/sumcheck.cu's header)."""
    head = max(0, M.bit_length() - TAIL_MAX.bit_length())
    return min(CLUSTER_MAX, max(1, (M >> head) // 128)), head


@functools.lru_cache(maxsize=None)
def _consts(spec: FieldSpec) -> np.ndarray:
    return cuda_fr.field_consts(spec)


def run_phase(lib, spec: FieldSpec, evals_f: torch.Tensor, evals_g: torch.Tensor,
              challenges: torch.Tensor, start: int, cluster: int, head: int, stream):
    """One ``sczk_product_phase`` call of ``lib`` over f, g [..., M, L] with
    the given cluster size and head rounds; returns (msgs [..., R, 3, L],
    f_fin, g_fin [..., 1, L]).  Checks nothing but the C entry's return
    code: ``_launch`` is the checked wrapper (the host emulation of the
    tests calls this with its own ``lib``)."""
    M, L = evals_f.shape[-2:]
    batch = tuple(evals_f.shape[:-2])
    B = evals_f.numel() // (M * L)
    R = M.bit_length() - 1
    f, g = _aligned(evals_f), _aligned(evals_g)
    ch = _aligned(challenges[start : start + R])
    n = B * R * 3 * L
    out = torch.empty(n + 2 * B * L, dtype=torch.int32, device=f.device)
    msgs, ff, fg = out[:n], out[n : n + B * L], out[n + B * L :]
    scratch_ptr = None
    if head:  # the head rounds' tables and partial sums, laid out by the C entry
        words = np.zeros(1, dtype=np.int64)
        cuda_build.check(lib.sczk_phase_scratch_words(M, B, head, words.ctypes.data),
                         f"sumcheck phase scratch [{B}, {M}] (head {head})")
        scratch = torch.empty(int(words[0]), dtype=torch.int32, device=f.device)
        scratch_ptr = scratch.data_ptr()
    err = lib.sczk_product_phase(f.data_ptr(), g.data_ptr(), ch.data_ptr(), msgs.data_ptr(),
                                 ff.data_ptr(), fg.data_ptr(), scratch_ptr, M, B, cluster, head,
                                 _consts(spec).ctypes.data, stream)
    cuda_build.check(err, f"sumcheck product phase [{B}, {M}] (K {cluster}, head {head})")
    return msgs.view(batch + (R, 3, L)), ff.view(batch + (1, L)), fg.view(batch + (1, L))


def _launch(spec: FieldSpec, evals_f: torch.Tensor, evals_g: torch.Tensor,
            challenges: torch.Tensor, start: int):
    shape = evals_f.shape
    L, M = shape[-1], shape[-2]
    R = M.bit_length() - 1
    if spec.num_words != 8 or L != spec.num_limbs:
        raise ValueError(f"the phase kernel takes 16-limb fields, got {spec.name} [.., {L}]")
    if M < 2 or M & (M - 1) or evals_g.shape != shape:
        raise ValueError(f"tables must be [..., 2^R, L] of one shape: {shape} vs {evals_g.shape}")
    if challenges.shape[0] < start + R:
        raise ValueError(f"{R} rounds from {start} need more than {challenges.shape[0]} challenges")
    for x in (evals_f, evals_g, challenges):
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise TypeError(f"kernel operands must be CUDA int32 tensors, got {x.device} {x.dtype}")
    K, H = plan(M)
    stream = torch.cuda.current_stream(evals_f.device).cuda_stream
    msgs, ff, fg = run_phase(_lib(), spec, evals_f, evals_g, challenges, start, K, H, stream)
    product_phase.launches += H + 1
    return list(msgs.unbind(-3)), ff, fg


def product_phase(F: Field, evals_f: torch.Tensor, evals_g: torch.Tensor,
                  challenges: torch.Tensor, start: int):
    """Full product fold: f, g [..., M, L] -> (msgs: list of R [..., 3, L],
    f_fin, g_fin [..., 1, L]); round r uses ``challenges[start + r]``."""
    if evals_f.device.type == "cpu" and evals_g.device.type == "cpu":
        return product_phase_plain(F.spec, evals_f, evals_g, challenges, start)
    return _launch(F.spec, evals_f, evals_g, challenges, start)


def _probe_operand(spec: FieldSpec, x: torch.Tensor, shape: tuple) -> torch.Tensor:
    if x.device.type != "cuda" or x.dtype != torch.int32 or tuple(x.shape) != shape:
        raise TypeError(f"want a CUDA int32 {shape}, got {x.device} {x.dtype} {tuple(x.shape)}")
    if spec.num_words != 8:
        raise ValueError(f"the Fr probes take 8-word fields, got {spec.name}")
    return _aligned(x)


def fr_mul_cc(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 over int32 [m, 16] Fr operands on the card by the
    carry-chain product the phase kernel folds with (a probe, to hold it
    against ``cuda_fr.mul``'s fmul<8>)."""
    m = a.shape[0]
    a, b = (_probe_operand(spec, x, (m, spec.num_limbs)) for x in (a, b))
    out = torch.empty_like(a)
    if m:
        cuda_build.check(_lib().sczk_fr_mul_cc(a.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                                               _consts(spec).ctypes.data,
                                               torch.cuda.current_stream(a.device).cuda_stream),
                         "fr_mul_cc")
    return out


def fr_mul_chain(spec: FieldSpec, xy: torch.Tensor, n: int, cc: bool) -> torch.Tensor:
    """x * y^n * R^-n by n dependent Fr products in one thread, for ``xy``
    int32 [2, 16] on the card: by the carry-chain product (``cc``) or by
    fmul<8>.  A probe of one product's latency in a chain."""
    xy = _probe_operand(spec, xy, (2, spec.num_limbs))
    out = torch.empty(spec.num_limbs, dtype=torch.int32, device=xy.device)
    cuda_build.check(_lib().sczk_fr_mul_chain(xy.data_ptr(), n, int(cc), out.data_ptr(),
                                              _consts(spec).ctypes.data,
                                              torch.cuda.current_stream(xy.device).cuda_stream),
                     "fr mul chain")
    return out


def smem_bytes(M: int, cluster: int) -> int:
    """Dynamic shared memory of a cluster block for a table of M elements
    (after any head rounds) over ``cluster`` blocks, from the C source."""
    return int(_lib().sczk_phase_smem(M, cluster))


def attributes() -> dict:
    """Registers, spill (local) bytes per thread and static shared bytes of
    the cluster kernel and the head round, from the card."""
    lib = _lib()
    attrs = {}
    for which, name in enumerate(("cluster", "head")):
        out = np.zeros(3, dtype=np.int32)
        cuda_build.check(lib.sczk_sumcheck_attrs(which, out.ctypes.data),
                         f"sumcheck attributes of {name}")
        attrs[name] = {"registers": int(out[0]), "spill_bytes": int(out[1]),
                       "static_smem_bytes": int(out[2])}
    return attrs


product_phase.launches = 0
