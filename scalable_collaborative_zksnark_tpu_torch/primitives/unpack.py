"""Party-axis unpack helpers and pss2ss -- the c_* phase-transition ops.

Mirrors the JAX package's ``primitives/unpack.py``:

* ``d_unpack_0``: the leader unpacks the gathered shares and broadcasts
  secret[0] to everyone;
* ``d_unpack`` / ``d_unpack2``: gather to a root and unpack there;
* ``d_unpack2_many``: batched and transposed variant;
* ``pss2ss``: one packed share per party -> l single-secret shares per
  party, as the rank-1 map ``out[j, k] = u[j] * v[k]`` with
  ``v = unpack(shares)`` and ``u`` the reconstructible single-secret
  packing vector.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams


@functools.lru_cache(maxsize=None)
def _pack_single_u(pp: PackedSharingParams) -> torch.Tensor:
    """Montgomery table u [n, L] on the field's device: shares_j = u_j * secret."""
    F = pp.field
    return F.array_from_ints([int(v) % F.p for v in pp.pack_single_reconstructible_vector()])


def d_unpack_0(pp: PackedSharingParams, net: PartyNet, share: torch.Tensor) -> torch.Tensor:
    """share [P, L] -> secret[0] broadcast to all parties [P, L]."""
    g = net.gather_to_root(share, "fr")  # [N, L]
    v0 = pp.unpack(g)[..., 0, :]  # [L]
    out = v0.expand((net.n,) + tuple(v0.shape))
    return net.scatter_from_root(out, "fr")


def d_unpack(pp: PackedSharingParams, net: PartyNet, share: torch.Tensor, receiver: int = 0):
    """share [P, L] -> secrets [l, L] (visible at `receiver`)."""
    g = net.gather_to_root(share, "fr", root=receiver)
    return pp.unpack(g)


def d_unpack2(pp: PackedSharingParams, net: PartyNet, share: torch.Tensor, receiver: int = 0):
    g = net.gather_to_root(share, "fr", root=receiver)
    return pp.unpack2(g)


def d_unpack2_many(pp: PackedSharingParams, net: PartyNet, shares: torch.Tensor,
                   receiver: int = 0) -> torch.Tensor:
    """shares [P, B, L] -> plain values [B * l, L] at `receiver`, slot-major."""
    B = shares.shape[-2]
    g = net.gather_to_root(shares, "fr", count=B, vec=True, root=receiver)  # [N, B, L]
    per_slot = pp.unpack2(g.movedim(0, -2))  # [B, l, L]
    return per_slot.reshape(per_slot.shape[:-3] + (B * pp.l, pp.field.L))


def pss2ss(pp: PackedSharingParams, net: PartyNet, share: torch.Tensor,
           count: bool = True) -> torch.Tensor:
    """share [P, ..., L] (one packed share per party per batch slot) ->
    [P, ..., l, L] regular shares.

    Communication: one gather of B field elements and one scatter of B*l
    per party; extra batch dims ride the same round.  ``count=False``
    moves the data without byte accounting."""
    F = pp.field
    B = int(np.prod(share.shape[1:-1], dtype=np.int64)) if share.ndim > 2 else 1
    if count:
        g = net.gather_to_root(share, "fr", count=B, vec=B > 1)  # [N, ..., L]
    else:
        g = net.gather_data_only(share)
    v = pp.unpack(g.movedim(0, -2))  # [..., l, L]
    u = net.party_rows(_pack_single_u(pp))  # [P, L]: the root scatters row j to party j
    bshape = v.shape[:-2]
    out = F.mul(u.reshape(u.shape[:1] + (1,) * (len(bshape) + 1) + (F.L,)), v[None])  # [P, .., l, L]
    if count:
        net._count_scatter(net.payload_bytes("fr", B * pp.l, vec=True))
    return out
