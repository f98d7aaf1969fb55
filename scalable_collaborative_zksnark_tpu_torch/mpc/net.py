"""Party-axis collectives with per-party byte accounting.

Mirrors the JAX package's ``mpc/net.py``.  The N MPC parties of the
reference are a tensor axis: protocol state lives in tensors shaped
``[N, ...]`` and every cross-party movement is a tensor op.  What remains
of the reference's network layer is its accounting: per-party upload and
download bytes at arkworks' compressed sizes, and a round count.

Modes:
* ``sim``    -- all N parties computed as a batch axis (results are real);
* ``leader`` -- one party materialised; gathers tile its data N times (the
  reference's fake network), costs are faithful, values are not.

A ``sim`` net may spread its parties over a ``torch.distributed`` process
group of W ranks (W dividing N): rank r holds parties [r N/W, (r + 1) N/W)
on the party axis of every tensor.  Gathers become all-gathers in party
order, scatters keep the rank's rows, and the src <-> dest exchange is one
all-to-all (``transpose_parties``).  What the leader computes on gathered
data runs on every rank on identical inputs, and each rank keeps its own
rows.  The byte and round counters stay the reference's accounting of all
N parties on every rank, so they equal the single-process net's.  A
collective takes its tensors where they lie (gloo takes CUDA ``int32``
tensors for both the all-gather and the all-to-all); a backend that
refuses one raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# arkworks serialize_compressed sizes (bytes)
SIZEOF = {
    "fr": 32,
    "g1": 48,
    "g2": 96,
}
VEC_PREFIX = 8  # arkworks Vec<T> length prefix (u64)

# torch renamed all_gather_into_tensor to all_gather_single; the same call
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor



class PartyNet:
    """Collective vocabulary + per-party byte accounting for N parties.

    ``group``: a ``torch.distributed`` process group over which a ``sim``
    net spreads its parties (None: every party in this process)."""

    def __init__(self, n_parties: int, mode: str = "sim", group=None):
        if mode not in ("sim", "leader"):
            raise ValueError(f"unknown mode {mode!r}")
        self.n = n_parties
        self.mode = mode
        self.up = [0] * n_parties
        self.down = [0] * n_parties
        self.rounds = 0
        self.group = group
        self.world, self.rank, self.party_offset = 1, 0, 0
        self._local = 1 if mode == "leader" else n_parties
        if group is not None:
            if mode != "sim":
                raise ValueError("only a sim net spreads its parties over a process group")
            self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
            if n_parties % self.world:
                raise ValueError(f"{n_parties} parties do not split over {self.world} ranks")
            self._local = n_parties // self.world
            self.party_offset = self.rank * self._local

    @property
    def local_parties(self) -> int:
        """Number of party slots materialised in tensors."""
        return self._local

    @property
    def party_slice(self) -> slice:
        """This process's parties: rows of a table drawn for all N."""
        return slice(self.party_offset, self.party_offset + self._local)

    def party_rows(self, x):
        """This process's rows of ``x`` [N, ...] (a view), or of each tensor
        of a tuple (a ``PointJ``): all of them in ``sim`` mode without a
        group, party 0's in ``leader`` mode."""
        if isinstance(x, tuple):
            return type(x)(*(self.party_rows(a) for a in x))
        return x[self.party_slice]

    def random_rows(self, F, tail, seed: int):
        """This process's rows of ``F.random((N,) + tail, seed)``: the rows
        the single-process sim run draws for these parties, cut on the host
        before the upload.  Without a group, ``F.random((P,) + tail, seed)``
        (a leader draws its one row, which is row 0 of the N)."""
        tail = tuple(tail)
        if self.group is None:
            return F.random((self._local,) + tail, seed)
        return F.random((self.n,) + tail, seed, rows=self.party_slice)

    # ------------------------------------------------------------------
    # byte accounting helpers
    # ------------------------------------------------------------------
    @staticmethod
    def payload_bytes(kind: str, count: int = 1, vec: bool = False) -> int:
        return (VEC_PREFIX if vec else 0) + SIZEOF[kind] * count

    def _count_gather(self, sz: int, root: int = 0):
        """Everyone sends `sz` bytes to `root`."""
        for i in range(self.n):
            if i == root:
                self.down[i] += sz * (self.n - 1)
            else:
                self.up[i] += sz
        self.rounds += 1

    def _count_scatter(self, sz: int, root: int = 0):
        """`root` sends `sz` bytes to everyone else."""
        for i in range(self.n):
            if i == root:
                self.up[i] += sz * (self.n - 1)
            else:
                self.down[i] += sz
        self.rounds += 1

    # ------------------------------------------------------------------
    # collectives (tensor semantics + accounting)
    # ------------------------------------------------------------------
    def gather_to_root(self, x, kind: str, count: int = 1, vec: bool = False, root: int = 0):
        """[P, ...] per-party values -> [N, ...] visible at the root.

        ``sim``: identity.  ``leader``: the single materialised party's
        value tiled N times (a broadcast view)."""
        self._count_gather(self.payload_bytes(kind, count, vec), root)
        return self.gather_data_only(x)

    def gather_data_only(self, x):
        """Data path of a gather whose bytes were counted with another
        payload; ``x`` is a tensor or a tuple of them (a ``PointJ``).
        Under a group, an all-gather in party order: every rank holds
        [N, ...].  A point travels as one collective of its three
        coordinates stacked on a second axis."""
        if isinstance(x, tuple):
            if self.group is not None:
                g = self._gather_rows(torch.stack(tuple(x), dim=1))  # [N, 3, ...]
                return type(x)(*(a.contiguous() for a in g.unbind(1)))
            return type(x)(*(self.gather_data_only(a) for a in x))
        if self.mode == "leader":
            return x[0:1].expand((self.n,) + tuple(x.shape[1:]))
        if self.group is not None:
            return self._gather_rows(x)
        return x

    def scatter_from_root(self, x, kind: str, count: int = 1, vec: bool = False, root: int = 0):
        """[N, ...] root-computed per-party values -> [P, ...]."""
        self._count_scatter(self.payload_bytes(kind, count, vec), root)
        return self.scatter_data_only(x)

    def scatter_data_only(self, x):
        """Data path of a scatter whose bytes are counted separately; ``x``
        is a tensor or a tuple of them (a ``PointJ``)."""
        if isinstance(x, tuple):
            return type(x)(*(self.scatter_data_only(a) for a in x))
        if self.mode == "leader":
            return x[0:1]
        if self.group is not None:
            return x[self.party_slice]
        return x

    def transpose_parties(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The src <-> dest exchange: ``x`` [P, ..., N, ...] (this process's
        source parties on axis 0, every destination party on ``axis``) ->
        [P, ..., N, ...] with this process's destination parties on axis 0
        and every source party on ``axis``: the single-process
        ``x.transpose(0, axis)``, as one all-to-all under a group.  No
        accounting (callers count the reference's rounds)."""
        if self.mode == "leader":
            raise ValueError("a leader net has one party and no exchange")
        if self.group is None:
            return x.transpose(0, axis)
        W, P = self.world, self._local
        # send[w] = the rows rank w's destination parties receive from ours:
        # [W, P_src, ..., P_dst, ...]
        send = x.unflatten(axis, (W, P)).movedim(axis, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv.flatten(0, 1).transpose(0, axis)  # [P_dst, ..., N_src, ...]

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[P, ...] on every rank -> [N, ...] in rank (so party) order."""
        x = x.contiguous()
        out = x.new_empty((self.n,) + tuple(x.shape[1:]))
        _all_gather(out, x, group=self.group)
        return out

    def leader_compute(self, x, f, kind_in: str, kind_out: str, count_in=1, count_out=1,
                       vec_in=False, vec_out=False):
        """gather -> f (party-axis map) -> scatter."""
        g = self.gather_to_root(x, kind_in, count_in, vec_in)
        return self.scatter_from_root(f(g), kind_out, count_out, vec_out)

    def all_to_all_rotating_root(self, kind: str, count_per_root: int = 1, vec: bool = False):
        """Accounting for N rounds of scatter-from-root-i."""
        for root in range(self.n):
            self._count_scatter(self.payload_bytes(kind, count_per_root, vec), root)

    def sync(self):
        """Barrier; counts one byte each way per party."""
        for i in range(self.n):
            self.up[i] += 1
            self.down[i] += 1
        self.rounds += 1

    # ------------------------------------------------------------------
    def comm(self, party: int = 0):
        """(upload, download) bytes of one party."""
        return self.up[party], self.down[party]

    def comm_total(self):
        return sum(self.up), sum(self.down)

    def reset_comm(self):
        self.up = [0] * self.n
        self.down = [0] * self.n
        self.rounds = 0

    def comm_snapshot(self):
        """Counter state, to discard counts of a repeated run."""
        return (list(self.up), list(self.down), self.rounds)

    def comm_restore(self, snap):
        self.up, self.down, self.rounds = list(snap[0]), list(snap[1]), snap[2]
