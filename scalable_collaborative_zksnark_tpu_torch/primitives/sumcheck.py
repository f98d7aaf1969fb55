"""Sumcheck family: local, collaborative (c_) and distributed (d_) variants.

Mirrors the JAX package's ``primitives/sumcheck.py`` (the reference's
``dsumcheck.rs``):

* ``sumcheck`` / ``sumcheck_product``: monolithic fold over 2^n
  evaluations; round i emits (sum_lo, sum_hi) (resp. the degree-2 triple
  at t = 0, 1, 2 with extrapolation 2*hi - lo) and folds the table by
  lo + c_i * (hi - lo).
* ``c_sumcheck`` / ``c_sumcheck_product``: the same fold on PSS shares;
  once the local table is one packed share, ``pss2ss`` turns it into l
  single-secret shares and the fold continues for log2(l) rounds.
* ``d_sumcheck`` / ``d_sumcheck_product``: plain data sliced 1/N per
  party; the leader sums the round messages and folds the N finals for
  log2(N) more rounds.

DOCUMENTED DEVIATION (kept from the JAX package): the reference's phase-2
loops reuse the first challenges; here phase 2 continues with
``challenge[n_local:]``, so the collaborative transcript verifies against
the same oracle as the monolithic one.

Tables are ``[..., M, L]`` (element axis -2, limb axis -1); party-batched
variants put the party axis first.  Every full product fold (all rounds
of a table) goes through ``cuda_sumcheck.product_phase``: the fold-phase
kernel on the card, its plain version on the CPU.  With ``SCZK_MXU`` set
(to anything but 0, read at each call) every round loop runs on the int8
engine first (``mxu_sumcheck``), as the JAX package's TPU default does;
the transcript is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.fr import Field
from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams
from . import cuda_sumcheck, mxu_sumcheck
from .unpack import pss2ss


def _halves(x):
    half = x.shape[-2] // 2
    return x[..., :half, :], x[..., half:, :]


def _fold(F: Field, x, ch):
    """lo + c * (hi - lo)  -- equals (1-c)*lo + c*hi exactly."""
    lo, hi = _halves(x)
    return F.add(lo, F.mul(ch, F.sub(hi, lo)))


def _rounds_single(F: Field, cur, challenges, start, count):
    """Fold ``count`` rounds; returns (messages list of [..., 2, L], cur)."""
    if count > 0 and mxu_sumcheck.available():
        return mxu_sumcheck.single_phase(F, cur, challenges, start, count)
    msgs = []
    for i in range(count):
        lo, hi = _halves(cur)
        msgs.append(torch.stack([F.sum(lo, axis=-2), F.sum(hi, axis=-2)], dim=-2))
        cur = _fold(F, cur, challenges[start + i])
    return msgs, cur


def _rounds_product(F: Field, cur_f, cur_g, challenges, start, count):
    """Product rounds; messages are (t0, t1, t2) triples [..., 3, L].

    With ``SCZK_MXU`` set, any count runs on the int8 engine; otherwise a
    full fold (count == log2 M) is one ``product_phase`` call and a partial
    one runs the unfused round loop."""
    if count > 0 and mxu_sumcheck.available():
        return mxu_sumcheck.product_phase(F, cur_f, cur_g, challenges, start, count)
    M = cur_f.shape[-2]
    if count > 0 and count == M.bit_length() - 1:
        return cuda_sumcheck.product_phase(F, cur_f, cur_g, challenges, start)
    msgs = []
    two = F.const(2)
    for i in range(count):
        lof, hif = _halves(cur_f)
        log, hig = _halves(cur_g)
        t0 = F.sum(F.mul(lof, log), axis=-2)
        t1 = F.sum(F.mul(hif, hig), axis=-2)
        ef = F.sub(F.mul(two, hif), lof)  # 2*hi - lo
        eg = F.sub(F.mul(two, hig), log)
        t2 = F.sum(F.mul(ef, eg), axis=-2)
        msgs.append(torch.stack([t0, t1, t2], dim=-2))
        ch = challenges[start + i]
        cur_f = _fold(F, cur_f, ch)
        cur_g = _fold(F, cur_g, ch)
    return msgs, cur_f, cur_g


# ---------------------------------------------------------------------------
# Local (monolithic) sumcheck -- the reference baseline + verifier oracle
# ---------------------------------------------------------------------------
def sumcheck(F: Field, evals: torch.Tensor, challenges: torch.Tensor) -> torch.Tensor:
    """[..., 2^n, L] -> messages [..., n+1, 2, L] (last = (0, final))."""
    n = evals.shape[-2].bit_length() - 1
    msgs, cur = _rounds_single(F, evals, challenges, 0, n)
    msgs.append(torch.stack([F.zeros(cur.shape[:-2]), cur[..., 0, :]], dim=-2))
    return torch.stack(msgs, dim=-3)


def sumcheck_product(F: Field, evals_f: torch.Tensor, evals_g: torch.Tensor,
                     challenges: torch.Tensor) -> torch.Tensor:
    """[..., 2^n, L] x2 -> messages [..., n+1, 3, L] (last = (0, f*g, 0))."""
    n = evals_f.shape[-2].bit_length() - 1
    msgs, cf, cg = _rounds_product(F, evals_f, evals_g, challenges, 0, n)
    z = F.zeros(cf.shape[:-2])
    msgs.append(torch.stack([z, F.mul(cf[..., 0, :], cg[..., 0, :]), z], dim=-2))
    return torch.stack(msgs, dim=-3)


# ---------------------------------------------------------------------------
# Collaborative (PSS-share) sumcheck
# ---------------------------------------------------------------------------
def c_sumcheck(pp: PackedSharingParams, net: PartyNet, shares: torch.Tensor,
               challenges: torch.Tensor) -> torch.Tensor:
    """shares [P, 2^n_loc, L] -> per-party messages [P, n_loc+log2(l)+1, 2, L]."""
    F = pp.field
    n_loc = shares.shape[-2].bit_length() - 1
    log_l = pp.l.bit_length() - 1
    msgs, cur = _rounds_single(F, shares, challenges, 0, n_loc)
    ss = pss2ss(pp, net, cur[..., 0, :])  # [P, l, L]
    msgs2, cur2 = _rounds_single(F, ss, challenges, n_loc, log_l)
    final = torch.stack([F.zeros(cur2.shape[:-2]), cur2[..., 0, :]], dim=-2)
    return torch.stack(msgs + msgs2 + [final], dim=-3)


def c_sumcheck_product(pp: PackedSharingParams, net: PartyNet, shares_f: torch.Tensor,
                       shares_g: torch.Tensor, challenges: torch.Tensor) -> torch.Tensor:
    """[P, 2^n_loc, L] x2 -> per-party messages [P, n_loc+log2(l)+1, 3, L].

    Phase-1 messages are degree-2(t+l) shares (products of shares);
    transcripts are opened with ``unpack2`` across the party axis."""
    F = pp.field
    n_loc = shares_f.shape[-2].bit_length() - 1
    log_l = pp.l.bit_length() - 1
    msgs, cf, cg = _rounds_product(F, shares_f, shares_g, challenges, 0, n_loc)
    ssf = pss2ss(pp, net, cf[..., 0, :])
    ssg = pss2ss(pp, net, cg[..., 0, :])
    msgs2, cf2, cg2 = _rounds_product(F, ssf, ssg, challenges, n_loc, log_l)
    z = F.zeros(cf2.shape[:-2])
    final = torch.stack([z, F.mul(cf2[..., 0, :], cg2[..., 0, :]), z], dim=-2)
    return torch.stack(msgs + msgs2 + [final], dim=-3)


# ---------------------------------------------------------------------------
# Distributed (plain-sliced) sumcheck
# ---------------------------------------------------------------------------
def d_sumcheck(F: Field, net: PartyNet, parts: torch.Tensor,
               challenges: torch.Tensor) -> torch.Tensor:
    """parts [P, ..., 2^n_loc, L] -> leader proof [..., n_loc+log2(N), 2, L].

    The leader output has no trailing (0, value) entry; extra batch dims
    ride the same leader round."""
    n_loc = parts.shape[-2].bit_length() - 1
    s = net.n.bit_length() - 1
    B = int(np.prod(parts.shape[1:-2], dtype=np.int64))
    msgs, cur = _rounds_single(F, parts, challenges, 0, n_loc)
    local = torch.stack(msgs, dim=-3)  # [P, ..., n_loc, 2, L]
    gathered = net.gather_to_root(local, "fr", count=B * (n_loc + 1) * 2, vec=True)
    final = net.gather_data_only(cur[..., 0, :])  # [N, ..., L]
    summed = F.sum(gathered, axis=0)  # [..., n_loc, 2, L]
    lead_msgs, _ = _rounds_single(F, final.movedim(0, -2), challenges, n_loc, s)
    lead = (
        torch.stack(lead_msgs, dim=-3)
        if lead_msgs
        else torch.zeros(summed.shape[:-3] + (0, 2, F.L), dtype=torch.int32, device=summed.device)
    )
    return torch.cat([summed, lead], dim=-3)


def d_sumcheck_product(F: Field, net: PartyNet, parts_f: torch.Tensor, parts_g: torch.Tensor,
                       challenges: torch.Tensor) -> torch.Tensor:
    """[P, ..., 2^n_loc, L] x2 -> leader proof [..., n_loc+log2(N), 3, L].

    Parties also push (last_f, last_g); the leader folds those N pairs for
    log2(N) further product rounds."""
    n_loc = parts_f.shape[-2].bit_length() - 1
    s = net.n.bit_length() - 1
    B = int(np.prod(parts_f.shape[1:-2], dtype=np.int64))
    msgs, cf, cg = _rounds_product(F, parts_f, parts_g, challenges, 0, n_loc)
    local = torch.stack(msgs, dim=-3)  # [P, ..., n_loc, 3, L]
    gathered = net.gather_to_root(local, "fr", count=B * (n_loc + 1) * 3, vec=True)
    lf = net.gather_data_only(cf[..., 0, :])  # [N, ..., L]
    lg = net.gather_data_only(cg[..., 0, :])
    summed = F.sum(gathered, axis=0)
    lead_msgs, _, _ = _rounds_product(F, lf.movedim(0, -2), lg.movedim(0, -2), challenges,
                                      n_loc, s)
    lead = (
        torch.stack(lead_msgs, dim=-3)
        if lead_msgs
        else torch.zeros(summed.shape[:-3] + (0, 3, F.L), dtype=torch.int32, device=summed.device)
    )
    return torch.cat([summed, lead], dim=-3)


# ---------------------------------------------------------------------------
# Transcript verifier oracles
# ---------------------------------------------------------------------------
def check_sumcheck(F: Field, h, proof, challenges) -> bool:
    """Verify a plain transcript: proof [k, 2] of ints, h claimed sum."""
    p = F.p
    if (proof[0][0] + proof[0][1]) % p != h % p:
        return False
    for i in range(1, len(proof)):
        x = challenges[i - 1]
        target = (proof[i - 1][0] + (proof[i - 1][1] - proof[i - 1][0]) * x) % p
        if (proof[i][0] + proof[i][1]) % p != target:
            return False
    return True


def check_sumcheck_product(F: Field, h, proof, challenges) -> bool:
    """Verify a degree-2 transcript: proof [k, 3] ints (t=0,1,2 values)."""
    p = F.p
    if (proof[0][0] + proof[0][1]) % p != h % p:
        return False
    inv2 = pow(2, -1, p)
    for i in range(1, len(proof)):
        x = challenges[i - 1]
        c = proof[i - 1][0]
        a = (proof[i - 1][2] - 2 * proof[i - 1][1] + proof[i - 1][0]) * inv2 % p
        b = (-proof[i - 1][2] + 4 * proof[i - 1][1] - 3 * proof[i - 1][0]) * inv2 % p
        target = (a * x * x + b * x + c) % p
        if (proof[i][0] + proof[i][1]) % p != target:
            return False
    return True
