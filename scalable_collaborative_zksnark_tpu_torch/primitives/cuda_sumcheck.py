"""Fused sumcheck-product fold phase: CUDA wrapper and plain version.

Replaces ``primitives/pallas_sumcheck.py`` ``_phase_kernel`` (via
``product_phase``).  For f, g ``[..., M, L]`` (M = 2^R) it returns the R
rounds' messages (t0, t1, t2) as canonical elements and the folded
finals, exactly as R rounds of the unfused loop in ``sumcheck.py`` would.
The kernel is ``csrc/sumcheck.cu`` (design and bound in its header):
per round one launch over all B*M/2 pairs that forms the products,
writes the folded tables and block-reduces the partial sums, then one
small launch that adds each slot's partials into the message.

A CPU tensor goes through ``product_phase_plain`` (the reference the tests
and ``chip_smoke.py`` hold the kernel to), a CUDA tensor through the
kernel; ``product_phase.launches`` counts both kernels' launches (two
per round).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..fields import cuda_fr
from ..fields.config import FieldSpec
from ..fields.fr import Field, column_sum

BLOCK = 256  # threads per block of the round kernel (kThreads in sumcheck.cu)

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sczk_product_round": [_VP, _VP, _I, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _VP, _VP],
    "sczk_partial_reduce": [_VP, _I, _VP, _I, _I, _I, _VP, _VP],
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


def _launch(spec: FieldSpec, evals_f: torch.Tensor, evals_g: torch.Tensor,
            challenges: torch.Tensor, start: int):
    shape = evals_f.shape
    L, M = shape[-1], shape[-2]
    R = M.bit_length() - 1
    batch = tuple(shape[:-2])
    B = shape.numel() // (M * L)
    if spec.num_words != 8 or L != spec.num_limbs:
        raise ValueError(f"the phase kernel takes 16-limb fields, got {spec.name} [.., {L}]")
    if M < 2 or M & (M - 1) or evals_g.shape != shape:
        raise ValueError(f"tables must be [..., 2^R, L] of one shape: {shape} vs {evals_g.shape}")
    if challenges.shape[0] < start + R:
        raise ValueError(f"{R} rounds from {start} need more than {challenges.shape[0]} challenges")
    for x in (evals_f, evals_g, challenges):
        if x.device.type != "cuda" or x.dtype != torch.int32:
            raise TypeError(f"kernel operands must be CUDA int32 tensors, got {x.device} {x.dtype}")
    lib = cuda_build.library("sumcheck", _SIGNATURES)
    consts = cuda_fr.field_consts(spec).ctypes.data
    stream = torch.cuda.current_stream(evals_f.device).cuda_stream
    dev = evals_f.device
    ch = _aligned(challenges[start : start + R])
    cur_f = _aligned(evals_f.reshape(B, M, L))
    cur_g = _aligned(evals_g.reshape(B, M, L))
    msgs = torch.empty((B, R, 3, L), dtype=torch.int32, device=dev)
    in_limbs = 1
    for r in range(R):
        half = M >> (r + 1)
        last = r == R - 1
        width = L if last else spec.num_words  # limbs out of the last round, else words
        nf = torch.empty((B, half, width), dtype=torch.int32, device=dev)
        ng = torch.empty_like(nf)
        nblk = -(-half // BLOCK)
        partial = torch.empty((B, nblk, 3, spec.num_words), dtype=torch.int32, device=dev)
        err = lib.sczk_product_round(
            cur_f.data_ptr(), cur_g.data_ptr(), in_limbs, nf.data_ptr(), ng.data_ptr(), int(last),
            partial.data_ptr(), ch[r].data_ptr(), half, nblk, B, consts, stream,
        )
        product_phase.launches += 1
        cuda_build.check(err, "sumcheck product round")
        err = lib.sczk_partial_reduce(partial.data_ptr(), nblk, msgs.data_ptr(), R, r, B,
                                      consts, stream)
        product_phase.launches += 1
        cuda_build.check(err, "sumcheck partial reduce")
        cur_f, cur_g, in_limbs = nf, ng, 0
    msgs = msgs.reshape(batch + (R, 3, L))
    return ([msgs[..., r, :, :] for r in range(R)],
            cur_f.reshape(batch + (1, L)), cur_g.reshape(batch + (1, L)))


def product_phase(F: Field, evals_f: torch.Tensor, evals_g: torch.Tensor,
                  challenges: torch.Tensor, start: int):
    """Full product fold: f, g [..., M, L] -> (msgs: list of R [..., 3, L],
    f_fin, g_fin [..., 1, L]); round r uses ``challenges[start + r]``."""
    if evals_f.device.type == "cpu" and evals_g.device.type == "cpu":
        return product_phase_plain(F.spec, evals_f, evals_g, challenges, start)
    return _launch(F.spec, evals_f, evals_g, challenges, start)


def attributes() -> dict:
    """Registers and spill (local) bytes per thread of the round kernel and
    the partial reduce, from the card."""
    lib = cuda_build.library("sumcheck", _SIGNATURES)
    attrs = {}
    for which, name in enumerate(("round", "partial_reduce")):
        out = np.zeros(2, dtype=np.int32)
        cuda_build.check(lib.sczk_sumcheck_attrs(which, out.ctypes.data),
                         f"sumcheck attributes of {name}")
        attrs[name] = {"registers": int(out[0]), "spill_bytes": int(out[1])}
    return attrs


product_phase.launches = 0
