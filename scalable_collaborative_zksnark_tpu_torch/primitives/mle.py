"""Multilinear-extension helpers (the JAX package's ``primitives/mle.py``;
parity: dist-primitive/src/mle.rs)."""

from __future__ import annotations

import torch

from ..fields.fr import Field
from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams
from .unpack import pss2ss


def fix_variable(F: Field, evals: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Partial evaluation fold (mle.rs:88-105): for each point p_i, table
    := lo + p_i * (hi - lo).  ``points`` is [k, L]; folds min(k, n) times."""
    n = evals.shape[-2].bit_length() - 1
    cur = evals
    for i in range(min(n, points.shape[0])):
        half = cur.shape[-2] // 2
        lo, hi = cur[..., :half, :], cur[..., half:, :]
        cur = F.add(lo, F.mul(points[i], F.sub(hi, lo)))
    return cur


def d_fix_variable(pp: PackedSharingParams, net: PartyNet, shares: torch.Tensor,
                   points: torch.Tensor) -> torch.Tensor:
    """Two-phase partial evaluation on shares with a pss2ss boundary
    (mle.rs:51-86).  shares [P, 2^n, L]; returns [P, m, L].  Phase 2
    continues at points[n:] (the JAX package's documented deviation; the
    reference indexes points[0..] again, mle.rs:76-84)."""
    F = pp.field
    n = shares.shape[-2].bit_length() - 1
    k = points.shape[0]
    cur = fix_variable(F, shares, points[: min(n, k)])
    if k <= n:
        return cur
    ss = pss2ss(pp, net, cur[..., 0, :])  # [P, l, L]
    log_l = pp.l.bit_length() - 1
    cur2 = fix_variable(F, ss, points[n : n + min(k - n, log_l)])
    return cur2[..., :1, :]


def pack_vec(pp: PackedSharingParams, secrets: torch.Tensor) -> torch.Tensor:
    """[..., M, L] secrets -> [n, ..., M/l, L] per-party share tables:
    chunks of l packed (operator.rs:7-20), party axis first."""
    M = secrets.shape[-2]
    if M % pp.l:
        raise ValueError(f"{M} secrets do not split into chunks of {pp.l}")
    chunks = secrets.reshape(secrets.shape[:-2] + (M // pp.l, pp.l, pp.field.L))
    shares = pp.pack_from_public(chunks)  # [..., M/l, n, L]
    return shares.movedim(-2, 0)


def unpack_vec(pp: PackedSharingParams, shares: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_vec: [n, ..., M/l, L] -> [..., M, L]."""
    secrets = pp.unpack(shares.movedim(0, -2))  # [..., M/l, l, L]
    return secrets.reshape(secrets.shape[:-3] + (-1, pp.field.L))


def unpack2_vec(pp: PackedSharingParams, shares: torch.Tensor) -> torch.Tensor:
    """pack_vec's inverse for degree-2(t+l) shares (products of shares)."""
    secrets = pp.unpack2(shares.movedim(0, -2))
    return secrets.reshape(secrets.shape[:-3] + (-1, pp.field.L))
