"""The party axis spread over processes and cards.

The counterpart of the JAX package's ``hyperplonk/sharding.py``.  There
the N = 8l parties are a mesh axis: the helpers only place the arrays and
XLA inserts the collectives.  Here each of W processes (one a card over
NCCL, or several on one card or on the CPU over gloo) holds N / W parties
on the party axis of every tensor, and ``PartyNet(N, "sim", group)``
carries each cross-party movement as a ``torch.distributed`` collective
(``mpc/net.py``).  The provers run unchanged; they give the single-process
sim run's bundle, in field values and affine points, and its comm
counters on every rank.

* ``init_party_group`` / ``close_party_group``: one process's membership,
  with the backend asked for and nothing else (no fallback: NCCL that
  cannot start raises);
* ``run_ranks``: W processes started with ``spawn``, each given its group
  and device; a failed rank fails the call;
* ``shard_parameters``: a rank's rows of whole prover inputs on the host,
  by field name;
* ``gather_bundle``: the whole bundle of any of the four provers from the
  ranks' parts;
* ``dryrun``: the counterpart of ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..curves.g1 import PointJ
from ..device import resolve, sync
from ..mpc.net import _all_gather, PartyNet
from ..utils.digest import proof_digest
from .collaborative import (cpermcheck, dhyperplonk, dhyperplonk_data_parallel, dpermcheck,
                            party_marks)
from .params import PARTY_FIELDS, packed_proving_parameters, shard_srs

BACKENDS = ("nccl", "gloo")


def init_party_group(backend: str, world_size: int, rank: int, init_method: str,
                     device="cuda", local_rank: int | None = None):
    """Join the default process group as ``rank`` of ``world_size``;
    returns (group, device).  ``nccl``: one rank a card, on
    ``cuda:{local_rank}`` (default ``rank``), made the current device.
    ``gloo``: the rank computes on ``device`` (``cpu``, or a card that
    several ranks may share).  ``init_method``: ``tcp://host:port`` or
    ``file://path``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend nccl needs a CUDA card; none is visible")
        local = rank if local_rank is None else local_rank
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants cuda:{local}, but "
                               f"{torch.cuda.device_count()} cards are visible")
        dev = torch.device("cuda", local)
    else:
        dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dist.group.WORLD, dev


def close_party_group():
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(fn, rank: int, world_size: int, backend: str, device, init_method: str,
                out_path: str, args: tuple, threads: int):
    """One spawned rank: join, run ``fn(group, device, *args)``, leave; its
    result (or its traceback, then exit code 1) pickled to ``out_path``."""
    torch.set_num_threads(threads)
    try:
        group, dev = init_party_group(backend, world_size, rank, init_method, device)
        result = fn(group, dev, *args)
        close_party_group()
        payload = ("ok", result)
    except Exception:  # noqa: BLE001 -- reported to the parent, which fails the run
        payload = ("error", traceback.format_exc())
    with open(out_path, "wb") as fh:
        pickle.dump(payload, fh)
    if payload[0] != "ok":
        sys.stderr.write(f"rank {rank} failed:\n{payload[1]}")
        sys.stderr.flush()
        os._exit(1)  # leave the others blocked; the parent ends them


def run_ranks(fn, world_size: int, backend: str = "gloo", device="cpu", args: tuple = (),
              timeout: float | None = None, threads: int = 1) -> list:
    """``fn(group, device, *args)`` in ``world_size`` spawned processes,
    one rank each (``init_party_group``: with ``nccl`` rank r on
    ``cuda:r``, with ``gloo`` every rank on ``device``); returns their
    results by rank.  ``fn`` and the results must pickle.  A rank that
    fails, or a run past ``timeout`` seconds, ends every rank and raises
    with the failing rank's traceback.  Start it before this process
    touches CUDA, or after, but never by ``fork``."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="sczk_ranks_")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world_size, backend, device,
                                                    init_method, outs[r], args, threads))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        t0 = time.monotonic()
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} exited with {procs[bad[0]].exitcode}:\n"
                                   f"{_failure(outs[bad[0]])}")
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{world_size} ranks still running after {timeout} s")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0]} exited with {procs[bad[0]].exitcode}:\n"
                               f"{_failure(outs[bad[0]])}")
        results = []
        for path in outs:
            with open(path, "rb") as fh:
                results.append(pickle.load(fh)[1])
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _failure(path: str) -> str:
    try:
        with open(path, "rb") as fh:
            status, detail = pickle.load(fh)
        return detail if status != "ok" else "(the rank wrote a result)"
    except (OSError, EOFError, pickle.UnpicklingError):
        return "(no report: the rank died before writing one)"


# ---------------------------------------------------------------------------
# The prover inputs and bundles
# ---------------------------------------------------------------------------
def shard_parameters(fields: dict, net: PartyNet) -> dict:
    """The net's rows of whole prover inputs held on the host, before their
    upload.  ``fields`` maps fields of ``PackedProvingParameters`` to host
    values: tables as arrays [N, ...], the two SRSs as host fields
    (``params.srs_to_host``'s form).  Every per-party table, named in
    ``PARTY_FIELDS`` (never guessed from a leading dimension: at (4, 1)
    over four ranks other axes are as long as a rank's two parties), keeps
    the net's rows, and so does each SRS's per-party packed level
    (``shard_srs``); the rest stays as it is.  Without a group, ``fields``."""
    if net.group is None:
        return fields
    out = dict(fields)
    for name in PARTY_FIELDS:
        if out[name].shape[0] != net.n:
            raise ValueError(f"{name} holds {out[name].shape[0]} parties, not {net.n}")
        out[name] = out[name][net.party_slice]
    for name in ("c_commitment", "d_commitment"):
        out[name] = shard_srs(out[name], net)
    return out


def _is_leaf(x) -> bool:
    """A bundle's leaf: a tensor or a point."""
    return isinstance(x, PointJ) or torch.is_tensor(x)


def _gather_leaf(net: PartyNet, leaf, per_party: bool, check_leader: bool):
    """A party leaf all-gathered to [N, ...]; a leader leaf kept (with
    ``check_leader``, held equal on every rank first)."""
    if per_party:
        rows = (leaf.x if isinstance(leaf, PointJ) else leaf).shape[0]
        if rows != net.local_parties:
            raise ValueError(f"a leaf marked per party holds {rows} rows, "
                             f"not the rank's {net.local_parties} parties")
        return net.gather_data_only(leaf)
    if check_leader:
        parts = (leaf if torch.is_tensor(leaf) else torch.stack(tuple(leaf))).contiguous()
        every = parts.new_empty((net.world,) + tuple(parts.shape))
        _all_gather(every, parts[None], group=net.group)
        if not bool((every == parts).all()):
            raise ValueError("a leader value differs between the ranks")
    return leaf


def gather_bundle(bundle, net: PartyNet, prover: str, check_leader: bool = False):
    """The whole bundle of ``prover`` (a name of ``collaborative.party_marks``)
    from every rank's part: party leaves all-gathered in party order,
    leader leaves kept, and with ``check_leader`` held equal across the
    ranks (one more all-gather each).  Every rank returns it.  Without a
    group, ``bundle``."""
    if net.group is None:
        return bundle

    def walk(x, mark):
        if isinstance(mark, bool):
            return _gather_leaf(net, x, mark, check_leader)
        return type(x)(walk(a, m) for a, m in zip(x, mark, strict=True))

    return walk(bundle, party_marks(prover, bundle))


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------
def dryrun_sizes(world_size: int) -> tuple[int, int]:
    """(n, l) of the dry run on ``world_size`` ranks, as
    ``dryrun_multichip``: l = max(W / 8, 2), so N = 8l parties split
    evenly; n = max(8, 4 + log2 l), so the layered zerocheck runs several
    layers and the leader tree is not trivial."""
    if world_size < 2 or world_size & (world_size - 1):
        raise ValueError(f"the dry run takes a power of two of at least 2 ranks, not {world_size}")
    l = max(world_size // 8, 2)
    return max(8, 4 + l.bit_length() - 1), l


def _dryrun_rank(group, dev, n: int, l: int):
    net = PartyNet(8 * l, "sim", group=group)
    pk = packed_proving_parameters(n, l, net, device=dev)
    report = {}
    for fn in (dhyperplonk, dhyperplonk_data_parallel, dpermcheck, cpermcheck):
        name = fn.__name__
        net.reset_comm()
        t0 = time.perf_counter()
        out = fn(n, pk, net)
        sync(dev)
        seconds = time.perf_counter() - t0
        whole = gather_bundle(out, net, name, check_leader=True)
        report[name] = {"seconds": seconds, "leaves": len(list(_leaves(whole))),
                        "digest": f"0x{proof_digest(pk.curve, whole):016x}",
                        "comm": list(net.comm(0)), "rounds": net.rounds}
    return report


def _leaves(x):
    if _is_leaf(x):
        yield x
    else:
        for a in x:
            yield from _leaves(a)


def dryrun(world_size: int, backend: str = "nccl", device="cuda",
           timeout: float | None = None) -> list:
    """One step of ``dhyperplonk`` and each of the three variants with the
    party axis spread over ``world_size`` ranks, at ``dryrun_sizes``;
    returns each rank's report (seconds, bundle leaves, digest and comm of
    every prover) and prints rank 0's."""
    n, l = dryrun_sizes(world_size)
    reports = run_ranks(_dryrun_rank, world_size, backend, device, args=(n, l), timeout=timeout)
    for name, row in reports[0].items():
        print(f"dryrun OK: {name} on {world_size} ranks ({backend}), N={8 * l} parties, n={n}, "
              f"{row['leaves']} leaves, digest {row['digest']}, {row['seconds']:.2f} s",
              flush=True)
    return reports
