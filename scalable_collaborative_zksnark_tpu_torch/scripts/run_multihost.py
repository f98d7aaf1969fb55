"""The collaborative prover with its parties spread over processes.

The port of the JAX package's ``scripts/run_multihost.py``.  The
reference runs one process per party over a TCP mesh; the JAX package one
process per host in a ``jax.distributed`` mesh.  Here each of W processes
joins one ``torch.distributed`` process group and holds N / W of the N =
8l parties (``hyperplonk/sharding.py``): with ``--backend nccl`` one
process a card, with ``--backend gloo`` processes on the CPU or several on
one card.  Each process runs, on a host of its own or beside the others::

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.run_multihost \\
        --init-method tcp://10.0.0.1:29500 --world-size 4 --rank $R \\
        --backend nccl --n 16 --l 8

Rank 0 prints the per-party prove time (the split prove's wall time,
synchronised; best of ``--repeat`` after one warm-up) and the comm of
party 0.  ``--digest PATH`` writes the canonical digest
(``utils/digest.proof_digest``) of the whole bundle, gathered from the
ranks, for comparison across process layouts: ``--world-size 1`` proves
every party in one process.  ``--local-demo`` starts four gloo processes
on this host's CPU and does the same.
"""

from __future__ import annotations

import argparse
import json
import time

import torch.distributed as dist

from ..device import resolve, sync
from ..hyperplonk.collaborative import dhyperplonk
from ..hyperplonk.params import packed_proving_parameters
from ..hyperplonk.sharding import (BACKENDS, close_party_group, gather_bundle, init_party_group,
                                   run_ranks)
from ..mpc.net import PartyNet
from ..utils.digest import proof_digest

LOCAL_DEMO_RANKS = 4


def prove(group, device, n: int, l: int, repeat: int) -> dict:
    """Set up and prove (n, l) in sim mode with this process's parties
    (all of them without a ``group``); returns its report (setup and prove
    seconds, comm, the whole bundle's digest)."""
    net = PartyNet(8 * l, "sim", group=group)
    t0 = time.perf_counter()
    pk = packed_proving_parameters(n, l, net, device=device)
    sync(device)
    setup_s = time.perf_counter() - t0

    def one():
        if group is not None:
            dist.barrier(group)
        t0 = time.perf_counter()
        out = dhyperplonk(n, pk, net)
        sync(device)
        return out, time.perf_counter() - t0

    net.reset_comm()
    out, first_s = one()  # kernel loads and first launches
    comm, rounds = net.comm(0), net.rounds
    runs = [one()[1] for _ in range(repeat)]
    whole = gather_bundle(out, net, "dhyperplonk")
    return {"rank": net.rank, "world_size": net.world, "parties": net.n,
            "local_parties": net.local_parties, "setup_s": setup_s, "first_s": first_s,
            "runs_s": runs, "comm": list(comm), "rounds": rounds,
            "digest": f"0x{proof_digest(pk.curve, whole):016x}"}


def report(rep: dict, digest_path=None):
    """Rank 0's lines, and the digest file."""
    print(f"# setup: {rep['setup_s']:.2f}s  {rep['world_size']} ranks, N={rep['parties']} "
          f"parties, {rep['local_parties']} a rank", flush=True)
    print(f"# first prove: {rep['first_s']:.3f}s", flush=True)
    if rep["runs_s"]:
        print(f"# warm prove: {min(rep['runs_s']):.3f}s", flush=True)
    print(f"Comm: {tuple(rep['comm'])}", flush=True)
    print(json.dumps(rep), flush=True)
    if digest_path:
        with open(digest_path, "w") as fh:
            fh.write(rep["digest"] + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--init-method", default=None,
                    help="rendezvous of the group (tcp://host:port or file://path); "
                         "needed with --world-size above 1")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--local-rank", type=int, default=None,
                    help="nccl: this process's card on its host (default: --rank)")
    ap.add_argument("--backend", choices=BACKENDS, default="nccl")
    ap.add_argument("--device", default="cuda",
                    help="gloo, or one process alone: cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=5, help="log2 gate count")
    ap.add_argument("--l", type=int, default=1, help="packing factor (N = 8l)")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--local-demo", action="store_true",
                    help=f"start {LOCAL_DEMO_RANKS} gloo processes on this host's CPU")
    ap.add_argument("--digest", default=None, metavar="PATH",
                    help="write the whole bundle's canonical digest (rank 0)")
    args = ap.parse_args(argv)

    if args.local_demo:
        reps = run_ranks(prove, LOCAL_DEMO_RANKS, "gloo", "cpu",
                         args=(args.n, args.l, args.repeat))
        report(reps[0], args.digest)
        print("local multi-process demo OK", flush=True)
        return 0
    if args.world_size == 1:
        rep = prove(None, resolve(args.device), args.n, args.l, args.repeat)
        report(rep, args.digest)
        return 0
    if args.init_method is None:
        ap.error("--world-size above 1 needs --init-method")
    group, device = init_party_group(args.backend, args.world_size, args.rank, args.init_method,
                                     args.device, args.local_rank)
    try:
        rep = prove(group, device, args.n, args.l, args.repeat)
    finally:
        close_party_group()
    if args.rank == 0:
        report(rep, args.digest)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
