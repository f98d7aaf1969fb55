"""Checks of the port's recorder (``utils/timer.py``) on one flagship prove,
against a profile of it that records the host's operations (and the
device's activity, on a card).

* The clock: each recorded span's start and end less those of its
  ``record_function`` annotation in the profile, in µs; the median and
  the worst.  The recorder's times and the profile's are one clock.
* The host's waits: each CUDA stream or device synchronisation made
  inside the prove is paired with the ``sync.*`` counter pass just before
  it; the syncs no pass accounts for are listed by the outermost and the
  innermost host operation and the recorder span open at them, and the
  passes no sync followed are counted.
* The ``sync.*`` counters of the prove, by site.

One warm-up ``dhyperplonk`` (leader mode, the bench entry's inputs), then
the checked one; the result prints as one JSON line.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.check_recorder [--n 16] [--l 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..device import DEFAULT, resolve, sync
from ..hyperplonk import collaborative as co
from ..hyperplonk.params import packed_proving_parameters
from ..mpc.net import PartyNet
from ..utils import timer

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def clock_offsets(spans, notes) -> list[int]:
    """Each recorded span's start and end less those of the profile's
    annotation of it (ns), spans and annotations of one name paired in
    start order; names whose counts differ are left out."""
    mine, theirs = {}, {}
    for s in spans:
        mine.setdefault(s.name.replace(" ", "_"), []).append((s.start_ns, s.end_ns))
    for name, a, b in notes:
        theirs.setdefault(name, []).append((a, b))
    out = []
    for name, ivs in mine.items():
        other = sorted(theirs.get(name, []))
        if len(other) == len(ivs):
            for (a, b), (c, d) in zip(sorted(ivs), other):
                out += [a - c, b - d]
    return out


def uncounted(passes, syncs) -> tuple[list[int], int]:
    """(the indexes in ``syncs`` that no counter accounts for, the counter
    passes no sync followed).  ``passes``: host times of the ``sync.*``
    counters' passes, each just before its site waits (one entry a wait);
    ``syncs``: host times of the CUDA runtime's synchronisations.  A pass
    covers the first sync after it, unless another pass comes first."""
    marks = sorted([(t, 0, k) for k, t in enumerate(passes)]
                   + [(t, 1, i) for i, t in enumerate(syncs)])
    out, lapsed, budget, last = [], 0, 0, None
    for t, kind, i in marks:
        if kind == 0:
            lapsed += budget if t != last else 0
            budget = budget + 1 if t == last else 1
            last = t
        elif budget:
            budget -= 1
        else:
            out.append(i)
    return out, lapsed + budget


def _at(intervals, t, inner: bool = True) -> str:
    """The name of the innermost (else outermost) of ``intervals``
    [(name, start, end)] open at ``t``, or "(none)"."""
    open_ = [iv for iv in intervals if iv[1] <= t < iv[2]]
    if not open_:
        return "(none)"
    pick = min if inner else max
    return pick(open_, key=lambda iv: iv[2] - iv[1])[0]


def check(prove, cuda: bool) -> dict:
    """Run ``prove()`` once with the recorder on under a profile; what the
    module's checks find."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    passes = []
    real = timer.count

    def count(name, k=1):
        if name.startswith("sync."):
            passes.extend([time.time_ns()] * k)
        real(name, k)

    timer.clear()
    timer.enable(True, show=False)
    timer.count = count
    try:
        with torch.profiler.profile(activities=acts) as prof:
            prove()
        spans, counters = timer.spans(), timer.counters()
    finally:
        timer.count = real
        timer.enable(False)
        timer.clear()
    start = min(s.start_ns for s in spans)
    end = max(s.end_ns for s in spans)
    names = {s.name.replace(" ", "_") for s in spans}
    notes, syncs, ops = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            continue
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        if name in names:
            notes.append((name, a, b))
        elif name in SYNC_CALLS:
            if start <= a <= end:
                syncs.append(a)
        else:
            ops.append((name, a, b))
    offsets = [abs(x) / 1e3 for x in clock_offsets(spans, notes)]
    lost, lapsed = uncounted(passes, syncs)
    recorded = [(s.name, s.start_ns, s.end_ns) for s in spans]
    where = {}
    for i in lost:
        key = (_at(ops, syncs[i], inner=False), _at(ops, syncs[i]), _at(recorded, syncs[i]))
        where[key] = where.get(key, 0) + 1
    sites = {k: v for c in counters.values() for k, v in c.items() if k.startswith("sync.")}
    return {"spans": len(spans),
            "clock_us": {"edges": len(offsets),
                         "median": statistics.median(offsets) if offsets else None,
                         "worst": max(offsets) if offsets else None},
            "syncs": len(syncs), "passes": len(passes),
            "uncounted": sorted(([*k, n] for k, n in where.items()), key=lambda r: -r[-1]),
            "passes_without_sync": lapsed,
            "syncs_by_site": dict(sorted(sites.items(), key=lambda kv: -kv[1]))}


def run(n: int = 16, l: int = 8, device=DEFAULT) -> dict:
    dev = resolve(device)
    net = PartyNet(8 * l, mode="leader")
    pk = packed_proving_parameters(n, l, net, device=dev)
    co.dhyperplonk(n, pk, net)  # warm-up: kernel loads, first launches
    sync(dev)
    found = check(lambda: co.dhyperplonk(n, pk, net), dev.type == "cuda")
    print(json.dumps(found), flush=True)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.n, args.l, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
