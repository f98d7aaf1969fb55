"""Degree reduction: degree-2(t+l) shares -> degree-(t+l) shares.

Mirrors the JAX package's ``primitives/degree_reduce.py`` (parity:
dist-primitive/src/degree_reduce.rs): the leader gathers, runs
unpack2 -> pack_from_public, and scatters.  Like the reference
(degree_reduce.rs:16) this omits the double-random-sharing mask.
"""

from __future__ import annotations

import torch

from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams


def degree_reduce(pp: PackedSharingParams, net: PartyNet, share: torch.Tensor) -> torch.Tensor:
    """share [P, L] -> reduced share [P, L]."""
    g = net.gather_to_root(share, "fr")  # [N, L]
    out = pp.pack_from_public(pp.unpack2(g))  # [N, L]
    return net.scatter_from_root(out, "fr")


def degree_reduce_many(pp: PackedSharingParams, net: PartyNet,
                       shares: torch.Tensor) -> torch.Tensor:
    """shares [P, B, L] -> reduced [P, B, L] (batched, one round)."""
    B = shares.shape[-2]
    g = net.gather_to_root(shares, "fr", count=B, vec=True)  # [N, B, L]
    red = pp.pack_from_public(pp.unpack2(g.movedim(0, -2)))  # [B, N, L]
    return net.scatter_from_root(red.movedim(-2, 0), "fr", count=B, vec=True)
