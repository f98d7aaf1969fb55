"""The benchmark's command: one run of one cell.

    python3 -m zkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port.  Loads and warms up
(timed as ``setup_s`` from the process's start), serves the cell's jobs
for ``--seconds`` (with ``--trace 1``: the program's spans synchronised,
then a short profile), checks a job drawn from the seed against the plain
reference, and prints one JSON object as the last line of standard
output.  Exits with another code than 0, and prints no result, without
enough cards, or when JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one host thread: the prove's host work is one Python thread, and idle
    # CPU thread pools only add to the shared host's noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")

    import torch

    from zkbench import harness, manifest

    torch.set_num_threads(1)

    try:
        chips = manifest.Manifest(ROOT).workload(args.workload)["chips"]
    except (OSError, KeyError, ValueError) as exc:
        print(f"no such cell: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda", started=STARTED)
    except harness.Outcome as out:
        print(str(out), file=sys.stderr)
        return out.code
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
