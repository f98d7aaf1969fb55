"""The span tree of one flagship prove on the port, from its own recorder.

The port of the JAX package's ``scripts/profile_phases.py``: one warm-up
``dhyperplonk`` (leader mode, the bench entry's inputs), then ``--reps``
proves with the recorder of ``utils/timer.py`` on; the fastest one's spans
print as a tree, each with its total and self time (its duration less what
its child spans cover) in ms and its family.  As in the benchmark's traced
window, the protocol steps (``trace`` spans) synchronise the device at
their edges and the primitives' spans do not: a primitive's time is the
host's, and its device work shows in the step that waits for it.
``--only-prims`` times the primitives on their own instead, through
``scripts/profile_primitives.py``.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.profile_phases [--n 16] [--l 8] [--reps 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

from ..device import DEFAULT, resolve, sync
from ..hyperplonk import collaborative as co
from ..hyperplonk.params import packed_proving_parameters
from ..mpc.net import PartyNet
from ..utils import timer
from . import profile_primitives


def tree(spans) -> list[dict]:
    """One job's spans, depth first in start order: a row each with its
    depth, total and self ms and family."""
    own = timer.self_ns(spans)
    kids: dict = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        kids.setdefault(s.parent, []).append(s)
    ids = {s.id for s in spans}
    rows = []

    def walk(s, depth):
        rows.append({"span": s.name, "depth": depth, "family": s.family,
                     "total_ms": (s.end_ns - s.start_ns) / 1e6, "self_ms": own[s.id] / 1e6})
        for k in kids.get(s.id, []):
            walk(k, depth + 1)

    for s in sorted((s for s in spans if s.parent not in ids), key=lambda s: s.start_ns):
        walk(s, 0)
    return rows


def run(n: int = 16, l: int = 8, device=DEFAULT, reps: int = 5) -> list[dict]:
    """The rows of ``tree`` for the fastest of ``reps`` recorded proves."""
    dev = resolve(device)
    net = PartyNet(8 * l, mode="leader")
    t0 = time.perf_counter()
    pk = packed_proving_parameters(n, l, net, device=dev)
    sync(dev)
    print(f"# setup: {time.perf_counter() - t0:.1f}s", flush=True)
    co.dhyperplonk(n, pk, net)  # warm-up: kernel loads, first launches
    sync(dev)
    timer.clear()
    timer.enable(True, show=False)
    timer.set_sync(lambda: sync(dev))
    try:
        for _ in range(max(reps, 1)):
            co.dhyperplonk(n, pk, net)
        spans = timer.spans()
    finally:
        timer.set_sync(None)
        timer.enable(False)
        timer.clear()
    roots = [s for s in spans if s.name == "dhyperplonk"]
    best = min(roots, key=lambda s: s.end_ns - s.start_ns)
    rows = tree([s for s in spans if s.job == best.job])
    print(f"# {len(rows)} spans in the fastest of {len(roots)} proves", flush=True)
    print(f"{'span':52s} {'total ms':>10s} {'self ms':>10s}  family", flush=True)
    for r in rows:
        print(f"{'  ' * r['depth'] + r['span']:52s} {r['total_ms']:10.3f} {r['self_ms']:10.3f}  "
              f"{r['family'] or ''}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--only-prims", action="store_true",
                    help="time the primitives (scripts/profile_primitives.py) instead")
    args = ap.parse_args(argv)
    if args.only_prims:
        profile_primitives.run(args.n, args.l, args.device)
    else:
        run(args.n, args.l, args.device, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
