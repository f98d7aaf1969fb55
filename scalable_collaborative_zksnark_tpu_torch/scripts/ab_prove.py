"""Time the prove of two checkouts in alternating turns on one card.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.ab_prove A_ROOT B_ROOT \
        [--n 16] [--l 8] [--repeat 5] [--rounds 1]

Each round runs, for each MSM configuration (dense; ``SCZK_MSM_DENSE=0``;
``SCZK_MXU=1``), each checkout's ``bench`` in a process of its own, in
the order A, B, B, A, so that a drift of the host or the card over the
call falls on both alike.  Every run prints its bench line (the median
of ``--repeat`` synchronised proves after a warm-up) with its checkout
and configuration; the last line is a summary: the card's name and power
limit and, per configuration and checkout, the medians of its runs.  A
run whose digest misses its pin fails the script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CONFIGS = {"dense": {}, "nondense": {"SCZK_MSM_DENSE": "0"}, "mxu": {"SCZK_MXU": "1"}}


def _bench(root: str, env: dict, n: int, l: int, repeat: int) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", "scalable_collaborative_zksnark_tpu_torch.bench", "--n", str(n),
         "--l", str(l), "--repeat", str(repeat)],
        cwd=root, env={**os.environ, **env}, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("a", help="root of the first checkout")
    ap.add_argument("b", help="root of the second checkout")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    medians = {cfg: {"a": [], "b": []} for cfg in CONFIGS}
    ok = True
    for _ in range(args.rounds):
        for cfg, env in CONFIGS.items():
            for side in ("a", "b", "b", "a"):
                rep = _bench(getattr(args, side), env, args.n, args.l, args.repeat)
                medians[cfg][side].append(rep["value"])
                ok &= rep["conformance"] == "pass"
                print(json.dumps({"checkout": side, "config": cfg, **rep}), flush=True)
    print(json.dumps({"card": card.strip().splitlines()[0], "median_s": medians}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
