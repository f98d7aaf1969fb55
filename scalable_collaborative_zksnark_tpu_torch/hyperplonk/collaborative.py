"""The collaborative HyperPlonk provers and the permcheck variants.

Mirrors the JAX package's ``hyperplonk/collaborative.py`` (parity:
dhyperplonk.rs):

* ``dhyperplonk`` (rs:159-571): 3 c_commit + 3 d_commit; six gate-identity
  c_sumcheck_product in one batch; the wire identity (the all-to-all
  witness exchange, c/d opens, the grand product via d_acc_product, 8
  d_commits and 5 d_opens, the direct zerocheck, the layered zerocheck
  over halving slices and the leader tree-top); then 3 c_open + 3 d_open;
* ``dhyperplonk_data_parallel`` (rs:573-960): the same without the
  all-to-all exchange (s stays local, rs:601-604);
* ``dpermcheck`` (rs:962-1247): the wire-identity section alone, with the
  exchange;
* ``cpermcheck`` (rs:1249-1385): the baseline permcheck on PSS shares,
  num/den and two c_acc_product_and_share pipelines.

Same-shape primitive calls are stacked on one batch axis, so one
collective round serves the group, as in the JAX package.  Each prover
ticks the party-net counters once per prove.

The JAX package's documented deviation in ``cpermcheck`` is kept: the
grand-product share streams (lengths S and S - N^2 / 2l, which the
reference feeds to power-of-two commits, dpoly_comm.rs:414,257) are
zero-padded to exactly S.

Share vectors are [P, len, L] (party axis first); plain ``_p`` vectors
are the 1/N slices.  Leader-only work (the tree top) runs once, on every
process when the parties are spread over a process group (its inputs are
gathered to all of them).  The JAX
package's documented deviation in ``_dsum_ch`` is kept.  Its TPU compile
workarounds (phased executables, their cache) are not ported: they return
the same bundle as ``dhyperplonk``.
"""

from __future__ import annotations

import torch

from ..curves.g1 import PointJ
from ..fields import mxu
from ..fields.fr import Field
from ..fields.mxu import Red
from ..mpc.net import PartyNet
from ..primitives import mxu_sumcheck
from ..primitives.acc_product import c_acc_product_and_share, d_acc_product
from ..primitives.poly_comm import c_commit, c_open, c_open_many
from ..primitives.sumcheck import c_sumcheck_product, d_sumcheck_product, sumcheck_product
from ..utils.timer import trace as timed
from .params import PackedProvingParameters


def _stackp(xs):
    """List of [P, M, L] tables -> [P, B, M, L] (the protocol batch axis)."""
    return torch.stack(xs, dim=1)


def _unstack(arr: torch.Tensor, B: int, axis: int = 1):
    return [arr.select(axis, i) for i in range(B)]


def _unstack_pt(pt, B: int, axis: int = 1):
    return [type(pt)(*(a.select(axis, i) for a in pt)) for i in range(B)]


def _pick(pt, b: int):
    """Entry b of a point batch's leading axis."""
    return type(pt)(*(a[b] for a in pt))


def _exchange_s(F: Field, net: PartyNet, local_s: torch.Tensor) -> torch.Tensor:
    """All-to-all broadcast of each party's witness-share block
    (dhyperplonk.rs:270-294): every party ends with s = concat_i local_s_i."""
    B = local_s.shape[-2]
    net.all_to_all_rotating_root("fr", count_per_root=B, vec=True)
    if net.mode == "leader":  # fake network: own block for every received one
        return local_s.repeat(1, net.n, 1)
    s = net.gather_data_only(local_s)  # [N, B, L], every party's block
    return s.reshape(1, net.n * B, F.L).expand(net.local_parties, net.n * B, F.L)


def _num_den_h(F: Field, num_base, sid_like, den_base, ssig_like, alpha, beta):
    """num = a + alpha sid + beta; den = b + alpha ssigma + beta; h = num / den
    (dhyperplonk.rs:326-339), by Montgomery batch inversion."""
    num = F.add(F.add(num_base, F.mul(alpha, sid_like)), beta)
    den = F.add(F.add(den_base, F.mul(alpha, ssig_like)), beta)
    return num, den, F.mul(num, F.batch_inv(den))


def _subtree_views(subtree: torch.Tensor):
    """v(1,x), v(x,0), v(x,1) stride views (dhyperplonk.rs:344-359)."""
    H = subtree.shape[-2] // 2
    return subtree[..., H:, :], subtree[..., 0::2, :], subtree[..., 1::2, :]


def _dsum_ch(net: PartyNet, ch: torch.Tensor) -> torch.Tensor:
    """Challenge order for d_sumcheck_product: local rounds ch[s:], leader
    rounds ch[:s].  The JAX package's documented deviation: the reference
    consumes ch in round order (dsumcheck.rs:319-353) while d_open binds
    the party variables to point[:s] first (dpoly_comm.rs:432-441), so its
    transcript and opening of one polynomial evaluate at different points."""
    s = net.n.bit_length() - 1
    return torch.cat([ch[s:], ch[:s]])


# The wire section's leaves that hold a party axis first ([P, ...], a row a
# party), by list: the first ones _wire_part_a makes, its c_sumcheck_product
# of s and V (proof 0), its d_commits of s and of the eight wire polynomials
# (commits 0-8) and its two c_opens of V (opens 0-1).  Every other leaf of
# the section is the leader's value, the same on every party.  A change to
# what _wire_part_a makes first changes these counts (``party_marks``).
_WIRE_PARTY_LEAVES = {"proofs": 1, "commits": 9, "opens": 2}


def _wire_part_a(n: int, pk: PackedProvingParameters, net: PartyNet, local_s_p, s_shares, c: int):
    """Wire identity 2.b-2.e.1 (dhyperplonk.rs:296-413): s commit and opens,
    num/den/h, the accumulation tree, the 8-poly commit group and the
    direct zerocheck.  Returns the lists and the tree slices for b and c;
    the per-party leaves come first (``_WIRE_PARTY_LEAVES``)."""
    F = pk.pp.field
    pp = pk.pp
    proofs, commits, opens = [], [], []
    # 2.b commit s; 2.c c_sumcheck_product of s and V at r1
    commits.append(pk.d_commitment.d_commit(net, local_s_p, c=c))
    proofs.append(c_sumcheck_product(pp, net, s_shares, pk.V, pk.challenge_r1))
    # 2.d co-open V at r1 and r2; d-open s at r2
    opens += c_open_many(pk.c_commitment, pp, net,
                         [(pk.V, pk.challenge_r1), (pk.V, pk.challenge_r2)], c=c)
    opens.append(pk.d_commitment.d_open(net, local_s_p, pk.challenge_r2, c=c))

    # 2.e distributed permcheck on s and eq(r1, x)
    with timed("Local: calculate den, num and h_p"):
        num, den, h_p = _num_den_h(F, local_s_p, pk.sid_p, pk.eq_r1_p, pk.ssigma_p, pk.alpha,
                                   pk.beta)
    subtree, leader_tree = d_acc_product(F, net, h_p)
    with timed("Local: get three v"):
        v1x, vx0, vx1 = _subtree_views(subtree)

    # the 8 wire polynomials share one shape: one d_commit, one d_open round
    grp8 = _stackp([pk.ssigma_p, pk.sid_p, h_p, num, den, v1x, vx0, vx1])
    commits += _unstack_pt(pk.d_commitment.d_commit(net, grp8, c=c), 8)
    val5, pis5 = pk.d_commitment.d_open(net, _stackp([pk.ssigma_p, pk.sid_p, h_p, num, den]),
                                        pk.challenge_r2, c=c)
    opens += [(val5[b], [_pick(pi, b) for pi in pis5]) for b in range(5)]

    # 2.e.1 direct zerocheck on p(x) = g * v0x - f (3 same-shape sumchecks)
    z3 = d_sumcheck_product(F, net, _stackp([den, h_p, num]),
                            _stackp([pk.eq_r2_p, den, pk.eq_r2_p]),
                            _dsum_ch(net, pk.challenge_r2))
    proofs += _unstack(z3, 3, axis=0)
    return proofs, commits, opens, (v1x, vx0, vx1, leader_tree)


def _product_round(F: Field, f: torch.Tensor, g: torch.Tensor, ch):
    """One product-sumcheck round over axis -2: ((t0, t1, t2) [..., 3, L],
    folded f, folded g)."""
    two = F.const(2)
    hf = f.shape[-2] // 2
    lof, hif = f[..., :hf, :], f[..., hf:, :]
    log_, hig = g[..., :hf, :], g[..., hf:, :]
    t0 = F.sum(F.mul(lof, log_), axis=-2)
    t1 = F.sum(F.mul(hif, hig), axis=-2)
    t2 = F.sum(F.mul(F.sub(F.mul(two, hif), lof), F.sub(F.mul(two, hig), log_)), axis=-2)
    msg = torch.stack([t0, t1, t2], dim=-2)
    return msg, F.add(lof, F.mul(ch, F.sub(hif, lof))), F.add(log_, F.mul(ch, F.sub(hig, log_)))


def _wire_b_sumchecks(pk: PackedProvingParameters, net: PartyNet, v1x, vx0, vx1, eq_full,
                      ch_full):
    """All layered-zerocheck sumchecks (dhyperplonk.rs:415-478) merged:
    bit-identical to G = n - log2 N separate ``d_sumcheck_product`` calls on
    the halving slices, with their byte accounting.

    Layer i starts one global round after layer i - 1 on a table half as
    long, so at global round g every active layer's table has the same size
    and consumes the same challenge ch_full[log2 N + g]: each round is one
    batched product round over the layers begun so far.  The leader rounds
    (log2 N per layer, on N-element tables) batch across layers with
    per-layer challenges ch_full[i + k].  With ``SCZK_MXU`` set the local
    rounds run on the int8 engine (``_wire_b_rounds_mxu``).  Returns
    per-layer transcripts [3, n_loc_i + s, 3, L]."""
    F = pk.pp.field
    s = net.n.bit_length() - 1
    half = v1x.shape[-2] // 2
    R = half.bit_length() - 1  # global rounds = log2(half) = G + 1
    G = R - 1  # layers = n - s
    P = v1x.shape[0]
    if G <= 0:
        return []
    slices, start, size = [], 0, half
    for _ in range(G):  # layer 1 = [0, half), then the second half of the last
        slices.append((start, size))
        start, size = start + size // 2, size // 2

    def new_tables(g):  # layer g's tables, joining at global round g
        st, sz = slices[g - 1]
        part = lambda t: t[..., st:st + sz, :]  # noqa: E731
        return (_stackp([part(eq_full), part(eq_full), part(vx0)]),
                _stackp([part(v1x), part(vx0), part(vx1)]))

    if mxu_sumcheck.available():
        msgs, cf, cg = _wire_b_rounds_mxu(F, new_tables, ch_full[s:], P, G, R)
    else:
        cur_f = cur_g = None
        msgs = []
        for g in range(1, R + 1):
            if g <= G:
                newf, newg = new_tables(g)
                cur_f = newf if cur_f is None else torch.cat([cur_f, newf], dim=-3)
                cur_g = newg if cur_g is None else torch.cat([cur_g, newg], dim=-3)
            msg, cur_f, cur_g = _product_round(F, cur_f, cur_g, ch_full[s + g])
            msgs.append(msg)  # [P, 3A, 3, L]
        cf = cur_f.reshape(P, G, 3, F.L)
        cg = cur_g.reshape(P, G, 3, F.L)

    # per-layer gather accounting and local message sums
    summed = []
    for i in range(1, G + 1):
        n_loc = R - i + 1
        net._count_gather(net.payload_bytes("fr", 3 * (n_loc + 1) * 3, vec=True))
        # layer i holds batch slots [3(i-1), 3i) from round i on
        loc = torch.stack([msgs[g - 1][:, 3 * (i - 1):3 * i] for g in range(i, R + 1)], dim=-3)
        summed.append(F.sum(net.gather_data_only(loc), axis=0))  # [3, n_loc, 3, L]

    # leader rounds, batched across layers: [N, G, 3, L] -> [G, 3, N, L]
    lf = net.gather_data_only(cf).movedim(0, -2)
    lg = net.gather_data_only(cg).movedim(0, -2)
    lead_msgs = []
    for k in range(s):
        # layer i's leader round k uses ch_full[i + k]: contiguous rows
        chk = ch_full[1 + k:1 + k + G][:, None, None, :]  # [G, 1, 1, L]
        msg, lf, lg = _product_round(F, lf, lg, chk)
        lead_msgs.append(msg)  # [G, 3, 3, L]
    if not lead_msgs:
        return summed
    lead = torch.stack(lead_msgs, dim=-3)  # [G, 3, s, 3, L]
    return [torch.cat([summed[i], lead[i]], dim=-3) for i in range(G)]


def _wire_b_rounds_mxu(F: Field, new_tables, ch, P: int, G: int, R: int):
    """The merged local rounds of ``_wire_b_sumchecks`` on the int8 engine
    (``SCZK_MXU``; the JAX package's MXU branch): the tables stay redundant
    across rounds, and one ``canon`` covers every message and both final
    tables, split back per round (P * 3A rows a message, A = min(g, G)).
    Round g uses ``ch[g]``.  Returns (per-round messages [P, 3A, 3, L],
    finals f and g [P, G, 3, L])."""
    spec = F.spec

    def cat(a, b):
        if a is None:
            return b
        W = max(a.W, b.W)
        return Red(torch.cat([mxu._pad_w(a.arr, W), mxu._pad_w(b.arr, W)], dim=-3),
                   max(a.bound, b.bound))

    cur_f = cur_g = None
    raw = []  # per global round: (t0, t1, t2) Red [P, 3A, W']
    for g in range(1, R + 1):
        if g <= G:
            newf, newg = new_tables(g)
            cur_f, cur_g = cat(cur_f, mxu.to_red(newf)), cat(cur_g, mxu.to_red(newg))
        lof, hif = mxu_sumcheck._halves(cur_f)
        log_, hig = mxu_sumcheck._halves(cur_g)
        t0 = mxu.dot_red(spec, lof, log_)
        t1 = mxu.dot_red(spec, hif, hig)
        df = mxu.sub_red(spec, hif, lof)
        dg = mxu.sub_red(spec, hig, log_)
        t2 = mxu.dot_red(spec, mxu.add_red(hif, df), mxu.add_red(hig, dg))  # 2 hi - lo
        raw.append((t0, t1, t2))
        m_c, _ = mxu.fold_matrix(spec, F, ch[g], df.bound, df.W)
        cur_f = mxu.add_red(lof, mxu.mul_shared(spec, df, m_c))
        cur_g = mxu.add_red(log_, mxu.mul_shared(spec, dg, m_c))
    flat = [t for tup in raw for t in tup] + [cur_f, cur_g]
    Wm = max(t.W for t in flat)
    rows = [mxu._pad_w(t.arr, Wm).reshape(-1, Wm) for t in flat]
    limbs = mxu.canon(spec, F, Red(torch.cat(rows), max(t.bound for t in flat)))
    msgs, off = [], 0
    for g in range(1, R + 1):
        cnt = P * 3 * min(g, G)
        trip = [limbs[off + k * cnt:off + (k + 1) * cnt].reshape(P, -1, F.L) for k in range(3)]
        msgs.append(torch.stack(trip, dim=-2))
        off += 3 * cnt
    cnt = P * 3 * G
    return (msgs, limbs[off:off + cnt].reshape(P, G, 3, F.L),
            limbs[off + cnt:off + 2 * cnt].reshape(P, G, 3, F.L))


def _zerocheck_layer(pk, net, cur_v1x, cur_vx0, cur_vx1, cur_eq, ch, c):
    """One layer of the layered zerocheck as its own calls
    (dhyperplonk.rs:415-478): 3 batched sumchecks and 3 batched opens."""
    F = pk.pp.field
    zl = d_sumcheck_product(F, net, _stackp([cur_eq, cur_eq, cur_vx0]),
                            _stackp([cur_v1x, cur_vx0, cur_vx1]), _dsum_ch(net, ch))
    val3, pis3 = pk.d_commitment.d_open(net, _stackp([cur_v1x, cur_vx0, cur_vx1]), ch, c=c)
    return zl, val3, pis3


def _wire_part_b(n: int, pk: PackedProvingParameters, net: PartyNet, v1x, vx0, vx1, c: int,
                 per_layer: bool = False):
    """2.e.2 the layered zerocheck.  The layers are data-independent: by
    default their sumchecks run merged (``_wire_b_sumchecks``) and their
    opens as one ``d_open_many``; ``per_layer`` runs each layer's calls on
    their own (``_zerocheck_layer``), which gives the same bundle and bytes."""
    s_bits = net.n.bit_length() - 1
    half = v1x.shape[-2] // 2
    cur = [v1x[..., :half, :], vx0[..., :half, :], vx1[..., :half, :],
           pk.eq_r2_p[..., : pk.eq_r2_p.shape[-2] // 2, :]]
    zls = None if per_layer else _wire_b_sumchecks(pk, net, v1x, vx0, vx1, pk.eq_r2_p,
                                                   pk.challenge_r2)
    proofs, opens, items, layer_opens = [], [], [], []
    for i in range(1, n - s_bits + 1):
        ch = pk.challenge_r2[i:]
        if per_layer:
            zl, val3, pis3 = _zerocheck_layer(pk, net, *cur[:3], cur[3], ch, c)
            layer_opens.append((val3, pis3))
        else:
            zl = zls[i - 1]
            items.append((_stackp(cur[:3]), ch))
        proofs += _unstack(zl, 3, axis=0)
        cur = [t[..., t.shape[-2] // 2:, :] for t in cur]
    if not per_layer:
        layer_opens = pk.d_commitment.d_open_many(net, items, c=c)
    for val3, pis3 in layer_opens:
        opens += [(val3[b], [_pick(pi, b) for pi in pis3]) for b in range(3)]
    return proofs, opens


def _wire_part_c(pk: PackedProvingParameters, net: PartyNet, leader_tree, eq_top, c: int):
    """The leader finishes the tree top locally (dhyperplonk.rs:480-511)."""
    F = pk.pp.field
    s_bits = net.n.bit_length() - 1
    with timed("Leader: Compute leader tree"):
        N = net.n
        lt_v1x, lt_vx0, lt_vx1 = leader_tree[N:, :], leader_tree[0::2, :], leader_tree[1::2, :]
        ch_top = pk.challenge_r2[:s_bits]
        lt3 = torch.stack([lt_vx0, lt_vx1, lt_v1x], dim=0)  # [3, N, L]
        commits = _unstack_pt(pk.d_commitment.commit(lt3, c=c), 3, axis=0)
        vals, pis = pk.d_commitment.open(lt3, ch_top, c=c)
        opens = [(vals[b], [_pick(pi, b) for pi in pis]) for b in range(3)]
        top3 = sumcheck_product(
            F, torch.stack([eq_top.expand(lt_v1x.shape)] * 2 + [lt_vx0], dim=0),
            torch.stack([lt_v1x, lt_vx0, lt_vx1], dim=0), ch_top)
        proofs = _unstack(top3, 3, axis=0)
    return proofs, commits, opens


def _wire_identity_distributed(n: int, pk: PackedProvingParameters, net: PartyNet, local_s_p,
                               s_shares, eq_top, c: int, per_layer: bool = False):
    """Steps 2.b-2.e (dhyperplonk.rs:296-511)."""
    proofs, commits, opens, (v1x, vx0, vx1, leader_tree) = _wire_part_a(
        n, pk, net, local_s_p, s_shares, c)
    pb, ob = _wire_part_b(n, pk, net, v1x, vx0, vx1, c, per_layer)
    pc, cc, oc = _wire_part_c(pk, net, leader_tree, eq_top, c)
    return proofs + pb + pc, commits + cc, opens + ob + oc


def _gate_identity(pk: PackedProvingParameters, net: PartyNet):
    """The six gate-identity sumchecks (dhyperplonk.rs:222-260) as one
    batched c_sumcheck_product."""
    F = pk.pp.field
    with timed("Local: Sum a and b"):
        sum_ab = F.add(pk.a_evals, pk.b_evals)
    with timed("Local: c-I"):
        sum_ci = F.add(F.neg(pk.c_evals), pk.I)
    fs = _stackp([pk.eq, pk.S1, pk.eq, pk.a_evals, pk.S2, pk.eq])
    gs = _stackp([pk.S1, sum_ab, pk.S2, pk.b_evals, pk.a_evals, sum_ci])
    batch = c_sumcheck_product(pk.pp, net, fs, gs, pk.challenge)  # [P, 6, R, 3, L]
    return _unstack(batch, 6, axis=1)


def _commit_step(pk: PackedProvingParameters, net: PartyNet, c: int):
    """Step 1: 3 collaborative + 3 distributed commits (rs:197-217), one
    c_commit batch and one d_commit batch."""
    cc = c_commit(pk.c_commitment, pk.pp, net, [pk.a_evals, pk.b_evals, pk.c_evals], c=c)
    dc = pk.d_commitment.d_commit(net, _stackp([pk.I_p, pk.S1_p, pk.S2_p]), c=c)
    return (*_unstack_pt(cc, 3, axis=1), *_unstack_pt(dc, 3, axis=1))


def _final_opens(pk: PackedProvingParameters, net: PartyNet, coms, c: int):
    """The final 3 c_open + 3 d_open (rs:517-554), one batched round each.
    Per party are the three (c_commit, c_open) pairs and the d_commits;
    the d_opens are the leader's (``_gate_coms_marks``)."""
    cval, cpis = c_open(pk.c_commitment, pk.pp, net,
                        _stackp([pk.a_evals, pk.b_evals, pk.c_evals]), pk.challenge, c=c)
    dval, dpis = pk.d_commitment.d_open(net, _stackp([pk.I_p, pk.S1_p, pk.S2_p]),
                                        pk.challenge, c=c)
    out = [(com, (cval[:, b], type(cpis)(*(a[:, b] for a in cpis))))
           for b, com in enumerate(coms[:3])]
    out += [(com, (dval[b], [_pick(pi, b) for pi in dpis])) for b, com in enumerate(coms[3:])]
    return out


# prover: (its default seed, the stride of its seed-derived placeholders,
# seed * stride + k)
_SEEDS = {"dhyperplonk": (2, 31), "dhyperplonk_data_parallel": (2, 37), "dpermcheck": (3, 41)}


def eq_top_table(F: Field, n_parties: int, prover: str = "dhyperplonk",
                 seed: int | None = None) -> torch.Tensor:
    """The public tree-top eq table [n_parties] that ``prover`` derives
    from its ``seed`` (its default if None), as its verifier needs it."""
    default, stride = _SEEDS[prover]
    return F.random((n_parties,), (default if seed is None else seed) * stride + 3)


def dhyperplonk(n: int, pk: PackedProvingParameters, net: PartyNet, seed: int = 2, c: int = 8,
                per_layer: bool = False):
    """The collaborative HyperPlonk prover (dhyperplonk.rs:159-571).

    Returns ``((gate_proofs, gate_coms), (wire_proofs, wire_commits,
    wire_opens))``, the JAX package's bundle.  ``per_layer`` runs the
    layered zerocheck layer by layer (the same bundle)."""
    F = pk.pp.field
    gc = 1 << n
    # protocol-internal placeholders, "jump from sky" (rs:187-190)
    local_s_p = net.random_rows(F, (gc * 4 // net.n,), seed * 31 + 1)
    local_s = net.random_rows(F, (gc * 4 // net.n // pk.pp.l,), seed * 31 + 2)
    eq_top = eq_top_table(F, net.n, "dhyperplonk", seed)

    net.sync()
    with timed("Distributed HyperPlonk"):
        with timed("Commit"):
            coms = _commit_step(pk, net, c)
        with timed("Distributed HyperPlonk Prover"):
            with timed("Gate identity"):
                gate_proofs = _gate_identity(pk, net)
            with timed("Wire identity"):
                s_shares = _exchange_s(F, net, local_s)  # 2.a (rs:270-294)
                wire = _wire_identity_distributed(n, pk, net, local_s_p, s_shares, eq_top, c,
                                                  per_layer)
            with timed("Open"):
                gate_coms = _final_opens(pk, net, coms, c)
    return (gate_proofs, gate_coms), wire


def dhyperplonk_data_parallel(n: int, pk: PackedProvingParameters, net: PartyNet, seed: int = 2,
                              c: int = 8):
    """The data-parallel-circuit variant (dhyperplonk.rs:573-960): as
    ``dhyperplonk`` but s stays local, with no all-to-all exchange
    (rs:601-604)."""
    F = pk.pp.field
    gc = 1 << n
    local_s_p = net.random_rows(F, (gc * 4 // net.n,), seed * 37 + 1)
    s_shares = net.random_rows(F, (gc * 4 // pk.pp.l,), seed * 37 + 2)
    eq_top = eq_top_table(F, net.n, "dhyperplonk_data_parallel", seed)

    net.sync()
    with timed("Distributed HyperPlonk (data-parallel)"):
        with timed("Commit"):
            coms = _commit_step(pk, net, c)
        with timed("Distributed HyperPlonk Prover"):
            with timed("Gate identity"):
                gate_proofs = _gate_identity(pk, net)
            with timed("Wire identity"):
                wire = _wire_identity_distributed(n, pk, net, local_s_p, s_shares, eq_top, c)
            with timed("Open"):
                gate_coms = _final_opens(pk, net, coms, c)
    return (gate_proofs, gate_coms), wire


def dpermcheck(n: int, pk: PackedProvingParameters, net: PartyNet, seed: int = 3, c: int = 8):
    """The improved permcheck on its own (dhyperplonk.rs:962-1247): the
    wire-identity section, with the all-to-all exchange."""
    F = pk.pp.field
    gc = 1 << n
    local_s = net.random_rows(F, (gc * 4 // net.n // pk.pp.l,), seed * 41 + 1)
    local_s_p = net.random_rows(F, (gc * 4 // net.n,), seed * 41 + 2)
    eq_top = eq_top_table(F, net.n, "dpermcheck", seed)

    net.sync()
    with timed("Distributed Permcheck"):
        s_shares = _exchange_s(F, net, local_s)
        return _wire_identity_distributed(n, pk, net, local_s_p, s_shares, eq_top, c)


def _pad_rows(F: Field, x: torch.Tensor, S: int) -> torch.Tensor:
    """A share stream cut or zero-padded to S rows (the module's deviation)."""
    k = S - x.shape[-2]
    if k <= 0:
        return x[..., :S, :]
    return torch.cat([x, x.new_zeros(x.shape[:-2] + (k, F.L))], dim=-2)


def cpermcheck(n: int, pk: PackedProvingParameters, net: PartyNet, c: int = 8):
    """The baseline collaborative permcheck (dhyperplonk.rs:1249-1385, paper
    section 4.3): everything on PSS shares, by c_acc_product_and_share."""
    F = pk.pp.field
    pp = pk.pp
    S = pk.V.shape[-2]  # gate_count * 4 / l shares a party

    net.sync()
    proofs, commits, opens = [], [], []
    with timed("Collaborative Permcheck"):
        with timed("Local: calculate num and den"):
            num = F.add(F.add(pk.V, F.mul(pk.alpha, pk.sid)), pk.beta)
            den = F.add(F.add(pk.eq_r1, F.mul(pk.alpha, pk.ssigma)), pk.beta)
        commits += _unstack_pt(c_commit(pk.c_commitment, pp, net, [pk.ssigma, pk.sid], c=c), 2)
        ov, opi = c_open(pk.c_commitment, pp, net, _stackp([pk.ssigma, pk.sid]),
                         pk.challenge_r1, c=c)
        opens += [(ov[:, b], type(opi)(*(a[:, b] for a in opi))) for b in range(2)]
        for evals in (num, den):
            streams = c_acc_product_and_share(pp, net, evals, pk.mask, pk.unmask0, pk.unmask1,
                                              pk.unmask2)
            vx0, vx1, v1x = (_pad_rows(F, x, S) for x in streams)
            commits += _unstack_pt(c_commit(pk.c_commitment, pp, net, [evals, vx0, vx1, v1x],
                                            c=c), 4)
            # the 4 opens between the commits and the final evaluation check
            # (rs:1371-1375): 5 same-shape, same-point opens in one batch
            ov, opi = c_open(pk.c_commitment, pp, net, _stackp([evals, vx0, vx1, v1x, evals]),
                             pk.challenge_r1, c=c)
            opens += [(ov[:, b], type(opi)(*(a[:, b] for a in opi))) for b in range(5)]
            sc3 = c_sumcheck_product(pp, net, _stackp([pk.eq_r1, pk.eq_r1, vx0]),
                                     _stackp([v1x, vx0, vx1]), pk.challenge_r1)
            proofs += _unstack(sc3, 3, axis=1)
    return proofs, commits, opens


def _marked(x, flag: bool):
    """``x``'s structure with each leaf as ``flag``."""
    if torch.is_tensor(x) or isinstance(x, PointJ):
        return flag
    return type(x)(_marked(a, flag) for a in x)


def _wire_marks(wire):
    """The wire section's marks (``_WIRE_PARTY_LEAVES``)."""
    return tuple([_marked(x, i < _WIRE_PARTY_LEAVES[key]) for i, x in enumerate(part)]
                 for key, part in zip(("proofs", "commits", "opens"), wire, strict=True))


def _gate_coms_marks(gate_coms):
    """``_final_opens``' marks: its c-side pairs per party; of its d-side
    pairs, the d_commit per party and the d_open the leader's."""
    return [_marked(x, True) if b < 3 else (True, _marked(x[1], False))
            for b, x in enumerate(gate_coms)]


def party_marks(prover: str, bundle):
    """The structure of ``prover``'s ``bundle`` with each leaf True where it
    holds a party axis first and False where it is the leader's value, the
    same on every party (``sharding.gather_bundle`` reads it)."""
    if prover == "cpermcheck":  # every proof, commit and open is on shares
        return _marked(bundle, True)
    if prover == "dpermcheck":
        return _wire_marks(bundle)
    if prover in ("dhyperplonk", "dhyperplonk_data_parallel"):
        (gate_proofs, gate_coms), wire = bundle
        return (_marked(gate_proofs, True), _gate_coms_marks(gate_coms)), _wire_marks(wire)
    raise ValueError(f"unknown prover {prover!r}")
