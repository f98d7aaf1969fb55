"""The control of the comparison that decides ``correct``, at a cell's own
size: the plain reference put in the program's place with one guarantee
of the configuration broken (every MSM scalar cut to its low
CONTROL_MSM_BITS bits, the step a faster MSM would tempt), compared with the
sound reference exactly as a run compares the program.  Prints, for each
seed, the numbers a run compares; they have to exceed their limits.

    python3 -m zkbench.control --workload <cell> --seeds 1,2,3

Not part of a benchmark run; needs no program, and runs on the card when
there is one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness, manifest, traffic
from .compare import bundle_mismatches
from .reference import g1

CONTROL_MSM_BITS = 128
"""The width every MSM scalar is cut to in the control."""


def readings(root, workload: str, seed: int, device, table) -> dict:
    cell = harness.Cell(root, workload)
    stream = traffic.WINDOW
    tables = {**traffic.static(cell.cfg, cell.traffic, seed, device),
              **traffic.fresh(cell.cfg, cell.traffic, seed, stream, device)}
    ps = traffic.prover_seed(seed, stream)
    want, want_comm = cell.reference.prove(cell.cfg, cell.traffic, tables, ps, device)
    got, got_comm = cell.reference.prove(cell.cfg, cell.traffic, tables, ps, device,
                                         msm_bits=CONTROL_MSM_BITS)
    bad, total = bundle_mismatches(got, want, table)
    return {"bundle_mismatches": bad, "bundle_elements": total,
            "comm_mismatches": int(tuple(got_comm) != tuple(want_comm))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    table = g1.GeneratorTable()
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(manifest.ROOT, args.workload, int(s), device, table)
        print(json.dumps({"seed": int(s), "bits": CONTROL_MSM_BITS, "device": device, **r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
