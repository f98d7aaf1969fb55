"""The collaborative HyperPlonk prove of one leader, written plainly.

What one server of an N = 8l committee computes and sends when it proves
a 2^n-gate circuit as the leader, with the other parties' messages
simulated as copies of its own (the reference implementation's ``leader``
build: dhyperplonk.rs:159-571 with its non-``comm`` network).  Field
values are ``field.Fr`` tensors; every group element is carried as its
discrete logarithm to G (a ``Pt``), which the SRS's known logarithms make
possible: an MSM is a dot product, a sum of points a sum of logarithms.
The caller turns each ``Pt`` into a point on the host (``g1``) to compare.

It follows the protocol as the benchmark's configuration fixes it:
phase 2 of every collaborative fold continues at the next challenge,
distributed sumchecks take their local rounds first, and grand-product
shares are as dhyperplonk.rs builds them.  Its only inputs are the job's
tables, the public challenges, the seed of the prover's own placeholder
draws and the SRS's logarithms.  ``msm_bits`` < 255 makes the control:
every MSM scalar cut to its low ``msm_bits`` bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import pss
from .field import BITS, LIMBS, R_MOD, Fr

G1_BYTES, FR_BYTES, VEC_PREFIX = 48, 32, 8
"""Compressed sizes on the wire (arkworks): a G1 point, a scalar, a vector's length."""


@dataclasses.dataclass
class Pt:
    """Group elements [...] by their logarithms to G: a tensor [..., 16]."""

    log: torch.Tensor


class Net:
    """Party 0's bytes sent and received and the rounds of an N-party
    network in which party 0 leads."""

    def __init__(self, n: int):
        self.n, self.up, self.down, self.rounds = n, 0, 0, 0

    @staticmethod
    def payload(kind: str, count: int = 1, vec: bool = False) -> int:
        return (VEC_PREFIX if vec else 0) + {"fr": FR_BYTES, "g1": G1_BYTES}[kind] * count

    def gather(self, size: int, root: int = 0):
        """Every party sends ``size`` bytes to ``root``."""
        if root == 0:
            self.down += size * (self.n - 1)
        else:
            self.up += size
        self.rounds += 1

    def scatter(self, size: int, root: int = 0):
        """``root`` sends ``size`` bytes to every other party."""
        if root == 0:
            self.up += size * (self.n - 1)
        else:
            self.down += size
        self.rounds += 1

    def sync(self):
        self.up += 1
        self.down += 1
        self.rounds += 1


def random_table(F: Fr, shape, seed: int) -> torch.Tensor:
    """The prover's seeded placeholder draw (dhyperplonk.rs:187-190's
    "jump from sky" values, as the benchmarked prover draws them): 16-bit
    limbs from ``RandomState(seed)``, the top one reduced below r's."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    limbs = rng.randint(0, 1 << BITS, size=tuple(shape) + (LIMBS,)).astype(np.int64)
    limbs[..., LIMBS - 1] %= R_MOD >> (BITS * (LIMBS - 1))
    return F.from_raw(torch.from_numpy(limbs))


class Prover:
    """One leader prove; ``run`` returns (bundle, net)."""

    def __init__(self, F: Fr, n: int, l: int, srs: dict, msm_bits: int = 255):
        self.F, self.n, self.l = F, n, l
        self.N = 8 * l
        self.s = self.N.bit_length() - 1
        self.log_l = l.bit_length() - 1
        self.srs = srs
        self.msm_bits = msm_bits
        m = pss.maps(l)
        self.unpack = F.from_ints(m["unpack"])  # [l, N]
        self.u0 = F.from_ints(m["single"][0])
        self.qw0 = F.from_ints(m["qw0"])
        self.net = Net(self.N)

    # -- helpers --------------------------------------------------------
    def _msm(self, scalars: torch.Tensor, logs: torch.Tensor) -> torch.Tensor:
        """The logarithm of sum_i scalars_i P_i: [..., M, 16] x [M, 16] -> [..., 16]."""
        F = self.F
        if self.msm_bits < 255:
            scalars = self._truncate(scalars)
        return F.sum(F.mul(scalars, logs), axis=-2)

    def _truncate(self, x: torch.Tensor) -> torch.Tensor:
        """The control's scalars: each value cut to its low ``msm_bits`` bits."""
        F = self.F
        one = torch.zeros(LIMBS, dtype=torch.int64, device=x.device)
        one[0] = 1
        std = F.mul(x, one)  # Montgomery form / R: the plain value's limbs
        bit = torch.arange(LIMBS * BITS, device=x.device).reshape(LIMBS, BITS)
        keep = ((bit < self.msm_bits).to(torch.int64) << torch.arange(BITS, device=x.device)).sum(-1)
        return F.from_raw(std & keep)

    def _halves(self, x):
        h = x.shape[-2] // 2
        return x[..., :h, :], x[..., h:, :]

    def _fold(self, x, ch):
        lo, hi = self._halves(x)
        return self.F.add(lo, self.F.mul(ch, self.F.sub(hi, lo)))

    def _fold_rounds(self, x, point, start: int, count: int):
        """``count`` rounds of q = hi - lo, x = lo + point[start + i] q."""
        F = self.F
        qs = []
        for i in range(count):
            lo, hi = self._halves(x)
            q = F.sub(hi, lo)
            qs.append(q)
            x = F.add(lo, F.mul(point[start + i], q))
        return qs, x

    def _product_rounds(self, f, g, chs):
        """Degree-2 sumcheck rounds: messages (sum lo lo, sum hi hi,
        sum (2hi - lo)(2hi - lo)) [..., 3, 16] and the folded tables."""
        F = self.F
        msgs = []
        for ch in chs:
            lof, hif = self._halves(f)
            log_, hig = self._halves(g)
            t0 = F.sum(F.mul(lof, log_))
            t1 = F.sum(F.mul(hif, hig))
            t2 = F.sum(F.mul(F.sub(F.add(hif, hif), lof), F.sub(F.add(hig, hig), log_)))
            msgs.append(torch.stack([t0, t1, t2], dim=-2))
            f, g = self._fold(f, ch), self._fold(g, ch)
        return msgs, f, g

    def _tile(self, x):
        """The leader's view of a gather in its network: its own value N times."""
        return x[0:1].expand((self.N,) + tuple(x.shape[1:]))

    # -- collaborative (packed-share) steps -----------------------------
    def pss2ss(self, share):
        """One packed share a slot [1, ..., 16] -> l single-secret shares
        [1, ..., l, 16]: gathered, unpacked, re-shared by u."""
        F = self.F
        B = int(np.prod(share.shape[1:-1], dtype=np.int64)) if share.ndim > 2 else 1
        self.net.gather(Net.payload("fr", B, vec=B > 1))
        g = self._tile(share).movedim(0, -2)  # [..., N, 16]
        v = F.sum(F.mul(self.unpack, g[..., None, :, :]), axis=-2)  # [..., l, 16]
        out = F.mul(self.u0, v)[None]
        self.net.scatter(Net.payload("fr", B * self.l, vec=True))
        return out

    def c_commit_logs(self, tables):
        """Shares [1, ..., M_k, 16] -> the leader's commitment shares [1, ..., B]:
        each MSM over the packed level of M_k l points, times q_0 sum(w)."""
        F = self.F
        logs = []
        for t in tables:
            level = (t.shape[-2] * self.l).bit_length() - 1
            logs.append(F.mul(self._msm(t, self.srs["packed"][level]), self.qw0))
        out = torch.stack(logs, dim=-2)
        B = int(np.prod(out.shape[1:-1], dtype=np.int64))
        self.net.gather(Net.payload("g1", B, vec=True))
        self.net.scatter(Net.payload("g1", B, vec=True))
        return out

    def _phase2(self, ss, challenge):
        """The log2(l) rounds after pss2ss: (folded [.., l >> k, 16], proof logs)."""
        F = self.F
        extra = []
        for i in range(self.log_l):
            lo, hi = self._halves(ss)
            q = F.sub(hi, lo)
            level = (q.shape[-2] * self.l).bit_length() - 1
            extra.append(self._msm(q, self.srs["packed"][level]))
            ss = F.add(lo, F.mul(challenge(i), q))
        return ss, extra

    def c_open(self, table, point):
        """Collaborative open of [1, ..., M, 16] at ``point``: (value share
        [1, ..., 16], proof logs [1, ..., log2 M + log2 l])."""
        n_loc = table.shape[-2].bit_length() - 1
        qs, cur = self._fold_rounds(table, point, 0, n_loc)
        coms = self.c_commit_logs(qs)
        ss = self.pss2ss(cur[..., 0, :])
        cur2, extra = self._phase2(ss, lambda i: point[n_loc + i])
        proofs = torch.cat([coms] + [e[..., None, :] for e in extra], dim=-2)
        return cur2[..., 0, :], Pt(proofs)

    def c_sumcheck_product(self, f, g, ch):
        """[1, ..., M, 16] x2 -> messages [1, ..., log2 M + log2 l + 1, 3, 16]."""
        F = self.F
        n_loc = f.shape[-2].bit_length() - 1
        msgs, cf, cg = self._product_rounds(f, g, [ch[i] for i in range(n_loc)])
        ssf = self.pss2ss(cf[..., 0, :])
        ssg = self.pss2ss(cg[..., 0, :])
        msgs2, cf2, cg2 = self._product_rounds(ssf, ssg,
                                               [ch[n_loc + i] for i in range(self.log_l)])
        z = F.zeros(cf2.shape[:-2])
        final = torch.stack([z, F.mul(cf2[..., 0, :], cg2[..., 0, :]), z], dim=-2)
        return torch.stack(msgs + msgs2 + [final], dim=-3)

    # -- distributed (sliced plain data) steps --------------------------
    def d_commit(self, table):
        """Slices [1, ..., M, 16] -> the commitment logs [1, ...]: the local
        MSM, summed over the N (copied) parties."""
        F = self.F
        k = table.shape[-2].bit_length() - 1
        B = int(np.prod(table.shape[1:-2], dtype=np.int64))
        local = self._msm(table, self.srs["powers"][k])
        self.net.gather(Net.payload("g1", B, vec=B > 1))
        total = F.mul(local, F.const(self.N))
        self.net.scatter(Net.payload("g1", B, vec=B > 1))
        return total

    def _open_bytes(self, B: int, m: int) -> int:
        return B * (FR_BYTES + VEC_PREFIX + G1_BYTES * m)

    def d_open(self, table, point):
        """Distributed open of [1, B..., 2^m, 16]: (value [B..., 16], proof
        logs: log2 N root rounds then m local rounds, each [B...])."""
        F = self.F
        m = table.shape[-2].bit_length() - 1
        B = int(np.prod(table.shape[1:-2], dtype=np.int64))
        qs, cur = self._fold_rounds(table, point, self.s, m)
        local = [self._msm(q, self.srs["powers"][q.shape[-2].bit_length() - 1]) for q in qs]
        self.net.gather(self._open_bytes(B, m))
        summed = [F.mul(lg[0], F.const(self.N)) for lg in local]
        root = self._tile(cur[..., 0, :]).movedim(0, -2)  # [B..., N, 16]
        root_qs, root_cur = self._fold_rounds(root, point, 0, self.s)
        root_pis = [self._msm(q, self.srs["roots"][q.shape[-2].bit_length() - 1]) for q in root_qs]
        self.net.scatter(self._open_bytes(B, self.s + m))
        return root_cur[..., 0, :], [Pt(x) for x in root_pis + summed]

    def d_sumcheck_product(self, f, g, ch):
        """[1, B, M, 16] x2 -> leader messages [B, log2 M + log2 N, 3, 16]:
        the parties' local rounds summed, then log2 N rounds over their
        N final pairs."""
        F = self.F
        n_loc = f.shape[-2].bit_length() - 1
        B = int(np.prod(f.shape[1:-2], dtype=np.int64))
        msgs, cf, cg = self._product_rounds(f, g, [ch[i] for i in range(n_loc)])
        local = torch.stack(msgs, dim=-3)  # [1, B, n_loc, 3, 16]
        self.net.gather(Net.payload("fr", B * (n_loc + 1) * 3, vec=True))
        summed = F.mul(local[0], F.const(self.N))
        lf = self._tile(cf[..., 0, :]).movedim(0, -2)  # [B, N, 16]
        lg = self._tile(cg[..., 0, :]).movedim(0, -2)
        lead, _, _ = self._product_rounds(lf, lg, [ch[n_loc + k] for k in range(self.s)])
        return torch.cat([summed, torch.stack(lead, dim=-3)], dim=-3)

    def _tree(self, x):
        """[..., M, 16] -> [x | pairwise-product levels up to the root | 0]."""
        F = self.F
        levels, cur = [x], x
        while cur.shape[-2] > 1:
            cur = F.mul(cur[..., 0::2, :], cur[..., 1::2, :])
            levels.append(cur)
        levels.append(F.zeros(x.shape[:-2] + (1,)))
        return torch.cat(levels, dim=-2)

    def _dsum_ch(self, ch):
        return torch.cat([ch[self.s:], ch[:self.s]])

    # -- the prove ------------------------------------------------------
    def run(self, job: dict, prover_seed: int):
        """``job``: the tables by the program's field names, Montgomery
        tensors with the party axis first.  Returns (bundle, net)."""
        F, n, N, l, s = self.F, self.n, self.N, self.l, self.s
        gc = 1 << n
        local_s_p = random_table(F, (1, gc * 4 // N), prover_seed * 31 + 1).to(F.device)
        local_s = random_table(F, (1, gc * 4 // N // l), prover_seed * 31 + 2).to(F.device)
        eq_top = random_table(F, (N,), prover_seed * 31 + 3).to(F.device)
        self.net.sync()
        j = job
        a, b, c = j["a_evals"], j["b_evals"], j["c_evals"]

        # 1. commit: 3 collaborative, 3 distributed
        cc = self.c_commit_logs([a, b, c])  # [1, 3]
        dc = self.d_commit(torch.stack([j["I_p"], j["S1_p"], j["S2_p"]], dim=1))  # [1, 3]
        coms = [Pt(cc[:, i]) for i in range(3)] + [Pt(dc[:, i]) for i in range(3)]

        # 2. gate identity: six product sumchecks in one batch
        sum_ab = F.add(a, b)
        sum_ci = F.add(F.neg(c), j["I"])
        fs = torch.stack([j["eq"], j["S1"], j["eq"], a, j["S2"], j["eq"]], dim=1)
        gs = torch.stack([j["S1"], sum_ab, j["S2"], b, a, sum_ci], dim=1)
        gate = self.c_sumcheck_product(fs, gs, j["challenge"])
        gate_proofs = [gate[:, i] for i in range(6)]

        # 3. wire identity
        wire = self._wire(j, local_s_p, local_s, eq_top)

        # 4. final opens
        cval, cpis = self.c_open(torch.stack([a, b, c], dim=1), j["challenge"])
        dval, dpis = self.d_open(torch.stack([j["I_p"], j["S1_p"], j["S2_p"]], dim=1),
                                 j["challenge"])
        gate_coms = [(coms[i], (cval[:, i], Pt(cpis.log[:, i]))) for i in range(3)]
        gate_coms += [(coms[3 + i], (dval[i], [Pt(p.log[i]) for p in dpis])) for i in range(3)]
        return ((gate_proofs, gate_coms), wire), self.net

    def _wire(self, j, local_s_p, local_s, eq_top):
        F, N, s = self.F, self.N, self.s
        r1, r2 = j["challenge_r1"], j["challenge_r2"]
        # 2.a every party's block of s to every party (the leader's own here)
        B = local_s.shape[-2]
        for root in range(N):
            self.net.scatter(Net.payload("fr", B, vec=True), root)
        s_shares = local_s.repeat(1, N, 1)

        proofs, commits, opens = [], [], []
        commits.append(Pt(self.d_commit(local_s_p)))
        proofs.append(self.c_sumcheck_product(s_shares, j["V"], r1))
        for point in (r1, r2):
            val, pis = self.c_open(j["V"], point)
            opens.append((val, pis))
        opens.append(self.d_open(local_s_p, r2))

        num = F.add(F.add(local_s_p, F.mul(j["alpha"], j["sid_p"])), j["beta"])
        den = F.add(F.add(j["eq_r1_p"], F.mul(j["alpha"], j["ssigma_p"])), j["beta"])
        h = F.mul(num, F.batch_inv(den))
        subtree = self._tree(h)
        self.net.gather(Net.payload("fr"))
        leader_tree = self._tree(self._tile(subtree[..., -2, :]))
        M = h.shape[-2]
        v1x, vx0, vx1 = subtree[..., M:, :], subtree[..., 0::2, :], subtree[..., 1::2, :]

        grp8 = torch.stack([j["ssigma_p"], j["sid_p"], h, num, den, v1x, vx0, vx1], dim=1)
        c8 = self.d_commit(grp8)
        commits += [Pt(c8[:, i]) for i in range(8)]
        val5, pis5 = self.d_open(torch.stack([j["ssigma_p"], j["sid_p"], h, num, den], dim=1), r2)
        opens += [(val5[i], [Pt(p.log[i]) for p in pis5]) for i in range(5)]
        z3 = self.d_sumcheck_product(torch.stack([den, h, num], dim=1),
                                     torch.stack([j["eq_r2_p"], den, j["eq_r2_p"]], dim=1),
                                     self._dsum_ch(r2))
        proofs += [z3[i] for i in range(3)]

        # 2.e.2 the layered zerocheck on halving slices
        half = M // 2
        cur = [v1x[..., :half, :], vx0[..., :half, :], vx1[..., :half, :],
               j["eq_r2_p"][..., :half, :]]
        layer_items = []
        for i in range(1, self.n - s + 1):
            ch = r2[i:]
            zl = self.d_sumcheck_product(torch.stack([cur[3], cur[3], cur[1]], dim=1),
                                         torch.stack([cur[0], cur[1], cur[2]], dim=1),
                                         self._dsum_ch(ch))
            proofs += [zl[k] for k in range(3)]
            layer_items.append((torch.stack(cur[:3], dim=1), ch))
            cur = [t[..., t.shape[-2] // 2:, :] for t in cur]
        for table, ch in layer_items:
            val3, pis3 = self.d_open(table, ch)
            opens += [(val3[k], [Pt(p.log[k]) for p in pis3]) for k in range(3)]

        # 2.e.3 the leader's tree top
        lt_v1x, lt_vx0, lt_vx1 = leader_tree[N:], leader_tree[0::2], leader_tree[1::2]
        ch_top = r2[:s]
        lt3 = torch.stack([lt_vx0, lt_vx1, lt_v1x])  # [3, N, 16]
        top_com = self._msm(lt3, self.srs["powers"][s])
        commits += [Pt(top_com[i]) for i in range(3)]
        qs, cur_top = self._fold_rounds(lt3, ch_top, 0, s)
        top_pis = [self._msm(q, self.srs["powers"][q.shape[-2].bit_length() - 1]) for q in qs]
        opens += [(cur_top[i, 0], [Pt(p[i]) for p in top_pis]) for i in range(3)]
        eqs = eq_top.expand(lt_v1x.shape)
        top_msgs, tf, tg = self._product_rounds(torch.stack([eqs, eqs, lt_vx0]),
                                                torch.stack([lt_v1x, lt_vx0, lt_vx1]),
                                                [ch_top[k] for k in range(s)])
        z = F.zeros((3,))
        final = torch.stack([z, F.mul(tf[:, 0], tg[:, 0]), z], dim=-2)
        top3 = torch.stack(top_msgs + [final], dim=-3)
        proofs += [top3[i] for i in range(3)]
        return proofs, commits, opens


def prove(cfg: dict, traffic: dict, tables: dict, prover_seed: int, device,
          msm_bits: int = 255):
    """The reference prove of one job: ``tables`` by name (the job's
    Montgomery limb tensors, any integer dtype), on ``device``.  Returns
    (bundle, (party 0's bytes sent, bytes received, rounds))."""
    from .srs import benchmark_srs_logs

    F = Fr(device)
    n = traffic["gates_log2"]
    srs = benchmark_srs_logs(F, n, cfg["l"], cfg["srs_seed"])
    job = {k: v.to(F.device, torch.int64) for k, v in tables.items()}
    bundle, net = Prover(F, n, cfg["l"], srs, msm_bits).run(job, prover_seed)
    return bundle, (net.up, net.down, net.rounds)
