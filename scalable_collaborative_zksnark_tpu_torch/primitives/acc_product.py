"""Product-accumulation tree (permcheck grand product): local, c_ and d_.

Mirrors the JAX package's ``primitives/acc_product.py`` (parity:
dist-primitive/src/dacc_product.rs):

* ``acc_product`` (dacc_product.rs:30-57): the level-order product tree
  ``[x | level1 | ... | root | 0]`` of 2^n evaluations (node M + j
  multiplies children 2j, 2j + 1) and its three stride views v(x,0),
  v(x,1), v(1,x);
* ``d_acc_product`` (dacc_product.rs:365-414): plain data sliced 1/N,
  local subtrees, roots gathered into a leader tree of length 2N;
* ``c_acc_product`` (dacc_product.rs:296-363): parties push their top N
  subtree elements; leader tree of length N^2;
* ``c_acc_product_and_share`` (dacc_product.rs:66-292): mask, all-to-all
  unpack2 redistribution, trees, re-share every level, unmask, and a
  2/N-sampled degree reduction whose result is discarded.

A tree level is one field product of the even and odd halves of the level
below; the rotating-root all-to-all is an axis transpose of the share
tensor (``PartyNet.transpose_parties``: one all-to-all when the parties
are spread over processes), and ``_merge`` (dacc_product.rs:416-428) a
reshape per level.
"""

from __future__ import annotations

import torch

from ..fields.fr import Field
from ..mpc.net import PartyNet
from ..pss.pss import PackedSharingParams
from ..utils.timer import spanned
from .degree_reduce import degree_reduce_many


def sub_index(i: int) -> tuple[int, int]:
    """Children of tree node i = (1,x): (x,0) and (x,1) (dacc_product.rs:18)."""
    first_one = i.bit_length() - 1
    x = (i & ~(1 << first_one)) << 1
    return x, x + 1


def _tree_levels(F: Field, x: torch.Tensor) -> list[torch.Tensor]:
    """Pairwise-product levels above the input layer (root included)."""
    levels = []
    cur = x
    while cur.shape[-2] > 1:
        cur = F.mul(cur[..., 0::2, :], cur[..., 1::2, :])
        levels.append(cur)
    return levels


def _tree_array(F: Field, x: torch.Tensor) -> torch.Tensor:
    """[..., M, L] -> level-order [..., 2M, L] with the last slot zeroed."""
    zero = F.zeros(x.shape[:-2] + (1,))
    return torch.cat([x] + _tree_levels(F, x) + [zero], dim=-2)


def acc_product(F: Field, x: torch.Tensor):
    """[..., M, L] -> (v(x,0), v(x,1), v(1,x)) each [..., M, L]."""
    result = _tree_array(F, x)
    M = x.shape[-2]
    return result[..., 0::2, :], result[..., 1::2, :], result[..., M:, :]


@spanned("acc_product")
def d_acc_product(F: Field, net: PartyNet, parts: torch.Tensor):
    """parts [P, M_loc, L] -> (subtree [P, 2*M_loc, L], leader_tree [2N, L]).

    Each party ships one element, its subtree root (dacc_product.rs:387)."""
    subtree = _tree_array(F, parts)
    g = net.gather_to_root(subtree[..., -2, :], "fr")  # [N, L]
    return subtree, _tree_array(F, g)


def c_acc_product(pp: PackedSharingParams, net: PartyNet, inputs: torch.Tensor):
    """inputs [P, M, L] (plain masked values) ->
    (subtree [P, 2M, L], leader_tree [N*N, L]).

    Parties push their top N subtree elements (dacc_product.rs:321-329);
    the leader interleaves them level by level, party-major, into the
    leader-tree bottom (:338-349), then products the N roots upward."""
    F = pp.field
    N = net.n
    subtree = _tree_array(F, inputs)
    if subtree.shape[-2] < N:
        raise ValueError(f"a subtree of {subtree.shape[-2]} has no top {N} elements")
    g = net.gather_to_root(subtree[..., -N:, :], "fr", count=N, vec=True)  # [N, N, L]
    parts = []
    start, ll = 0, N // 2
    while ll > 0:
        parts.append(g[:, start : start + ll, :].reshape(N * ll, F.L))
        start += ll
        ll >>= 1
    roots = g[:, N - 2, :]  # each party's subtree root
    upper = _tree_array(F, roots)[N:, :]  # levels above + zero slot
    return subtree, torch.cat(parts + [upper], dim=0)


def _pack_stream(pp: PackedSharingParams, vals: torch.Tensor) -> torch.Tensor:
    """[..., K*l, L] plain values -> [..., n, K, L] per-party share streams
    (chunks of l packed, then transposed; dacc_product.rs:118-148)."""
    F = pp.field
    K = vals.shape[-2] // pp.l
    chunks = vals.reshape(vals.shape[:-2] + (K, pp.l, F.L))
    return pp.pack_from_public(chunks).movedim(-2, -3)  # [..., n, K, L]


def _merge(r: torch.Tensor, l: int) -> torch.Tensor:
    """The reference's ``merge`` (dacc_product.rs:416-428) on share streams.

    r: [dest, src, K, L] received streams; level chunks of size
    next_pow2(K+1)/2, halving, each concatenated src-major.  Tail chunks
    that no longer fit are dropped (the leader tree covers them)."""
    K = r.shape[-2]
    if K == 0:
        return r.reshape(r.shape[:-3] + (0, r.shape[-1]))
    out = []
    num = 1 << ((K + 1).bit_length() - 1)  # next_pow2(K+1) >> 1
    start = 0
    while start + num <= K:
        sl = r[..., start : start + num, :]  # [dest, src, num, L]
        out.append(sl.reshape(sl.shape[:-3] + (-1, sl.shape[-1])))
        start += num
        num >>= 1
    return torch.cat(out, dim=-2)


@spanned("acc_product")
def c_acc_product_and_share(pp: PackedSharingParams, net: PartyNet, shares: torch.Tensor,
                            masks: torch.Tensor, unmask0: torch.Tensor,
                            unmask1: torch.Tensor, unmask2: torch.Tensor,
                            run_reduce: bool = True):
    """shares/masks [P, S, L] -> (share0, share1, share2) [P, K_out, L].

    The full pipeline of dacc_product.rs:66-292.  ``unmask*`` are per-party
    share vectors at least as long as the outputs.  Like the reference, the
    final degree reduction runs on a 2/N sample of each output for its cost
    and its result is discarded (dacc_product.rs:279-287)."""
    F = pp.field
    N = net.n
    S = shares.shape[-2]
    if S <= N:
        raise ValueError(f"{S} shares per party do not exceed the {N} parties")
    B = S // N

    # mask, then all-to-all: block i of every party -> party i, unpacked
    # to plain values (N concurrent d_unpack2_many, rs:94-104)
    masked = F.mul(shares, masks)
    P = masked.shape[0]
    blocks = masked.reshape(P, N, B, F.L)
    for i in range(N):
        net._count_gather(net.payload_bytes("fr", B, vec=True), root=i)
    if net.mode == "leader":
        # fake network: the one party unpacks N copies of its own block
        g = blocks[0, 0][:, None, :].expand(B, N, F.L)
        masked_x = pp.unpack2(g).reshape(1, B * pp.l, F.L)
    else:
        byroot = net.transpose_parties(blocks, 1)  # [root, src, B, L]
        masked_x = pp.unpack2(byroot.movedim(1, -2)).reshape(P, B * pp.l, F.L)

    subtree, leader_tree = c_acc_product(pp, net, masked_x)
    M = masked_x.shape[-2]

    # share the subtree minus its top N elements (rs:113-149)
    sts = subtree[..., : 2 * M - N, :]
    p0 = _pack_stream(pp, sts[..., 0::2, :])  # [P, n_dest, K0, L]
    p1 = _pack_stream(pp, sts[..., 1::2, :])
    p2 = _pack_stream(pp, sts[..., M : 2 * M - N, :])
    K0, K2 = p0.shape[-2], p2.shape[-2]
    # rotating-root exchange (rs:155-203): a src <-> dest transpose
    net.all_to_all_rotating_root("fr", count_per_root=K0, vec=True)
    net.all_to_all_rotating_root("fr", count_per_root=K0, vec=True)
    net.all_to_all_rotating_root("fr", count_per_root=K2, vec=True)
    if net.mode == "leader":  # own shares stand in for the received ones
        received = (p0[:1], p1[:1], p2[:1])
    else:
        received = tuple(net.transpose_parties(x, 1) for x in (p0, p1, p2))
    outs = [_merge(r, pp.l) for r in received]

    # the leader shares the leader tree (rs:213-263)
    lts = (leader_tree[0::2, :], leader_tree[1::2, :], leader_tree[N * N // 2 :, :])
    for j, lt in enumerate(lts):
        packed = _pack_stream(pp, lt)  # [n, Kl, L]
        outs[j] = torch.cat([outs[j], net.scatter_from_root(packed, "fr", count=packed.shape[-2],
                                                             vec=True)], dim=-2)

    # unmask (rs:266-276)
    outs = [F.mul(o, u[..., : o.shape[-2], :]) for o, u in zip(outs, (unmask0, unmask1, unmask2))]

    # 2/N-sampled degree reduction, result discarded (rs:279-287)
    if run_reduce:
        k = outs[0].shape[-2] // pp.n * 2
        if k:
            for o in outs:
                degree_reduce_many(pp, net, o[..., :k, :])
    return tuple(outs)
