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
"""

from __future__ import annotations

# arkworks serialize_compressed sizes (bytes)
SIZEOF = {
    "fr": 32,
    "g1": 48,
    "g2": 96,
}
VEC_PREFIX = 8  # arkworks Vec<T> length prefix (u64)


class PartyNet:
    """Collective vocabulary + per-party byte accounting for N parties."""

    def __init__(self, n_parties: int, mode: str = "sim"):
        if mode not in ("sim", "leader"):
            raise ValueError(f"unknown mode {mode!r}")
        self.n = n_parties
        self.mode = mode
        self.up = [0] * n_parties
        self.down = [0] * n_parties
        self.rounds = 0

    @property
    def local_parties(self) -> int:
        """Number of party slots materialised in tensors."""
        return 1 if self.mode == "leader" else self.n

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
        payload; ``x`` is a tensor or a tuple of them (a ``PointJ``)."""
        if isinstance(x, tuple):
            return type(x)(*(self.gather_data_only(a) for a in x))
        if self.mode == "leader":
            return x[0:1].expand((self.n,) + tuple(x.shape[1:]))
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
        return x

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
