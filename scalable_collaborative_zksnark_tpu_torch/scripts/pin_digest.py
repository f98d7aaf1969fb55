"""The port's canonical proof digest of the (n, l) leader-mode prove.

The port of the JAX package's ``scripts/pin_digest.py``: it proves
``dhyperplonk`` at (n, l) in leader mode on the requested device and
prints the canonical digest (``utils/digest.proof_digest``: G1 points
normalized to affine first, so any MSM configuration gives the same
value).  The pins in ``bench.PINS`` still come from the JAX package on the
CPU; this prints what the port proves, to hold against them, and whether
it matches the pin where there is one.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.pin_digest --n 16 --l 8 [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

from ..bench import PINS
from ..device import DEFAULT, resolve, sync
from ..hyperplonk.collaborative import dhyperplonk
from ..hyperplonk.params import packed_proving_parameters
from ..mpc.net import PartyNet
from ..utils.digest import proof_digest


def run(n: int = 16, l: int = 8, device=DEFAULT) -> dict:
    """Set up and prove (n, l) once on ``device``: the digest, the pin (None
    where ``bench.PINS`` has none) and the seconds it took."""
    dev = resolve(device)
    t0 = time.perf_counter()
    net = PartyNet(8 * l, mode="leader")
    pk = packed_proving_parameters(n, l, net, device=dev)
    digest = proof_digest(pk.curve, dhyperplonk(n, pk, net))
    sync(dev)
    return {"n": n, "l": l, "digest": digest, "pin": PINS.get((n, l)),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.n, args.l, args.device)
    print(f"# {out['seconds']:.1f}s", file=sys.stderr)
    print(f"({args.n}, {args.l}): 0x{out['digest']:016X}")
    if out["pin"] is None:
        return 0
    return 0 if out["digest"] == out["pin"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
