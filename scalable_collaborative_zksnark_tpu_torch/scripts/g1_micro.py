"""Micro-timing of the G1 kernels that set the MSM's cost model.

The port of the JAX package's ``scripts/g1_micro.py``, through the port's
wrappers: the dense MSM's accumulate (``cuda_g1.accumulate``: ``steps``
mixed adds on each of ``lanes`` lanes, one bucket a lane, the JAX
script's 100 steps of ``add_reset_lazy``), 100 point adds on ``lanes``
lanes (``Curve.add``), the scalar ladder (``Curve.scalar_mul``) on
full-width scalars at ``ladder`` lanes, and Horner (``cuda_g1.horner``)
at the (W, c, C) of ``horner``.  A row is the best of ``reps`` runs after
a first one, each between two synchronisations of the device.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.g1_micro [--reps 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..curves import cuda_g1
from ..curves.g1 import BLS12_381_G1_GEN, bls12_381_g1, map_points
from ..device import DEFAULT, resolve, sync
from ..primitives.poly_comm import rand_points_flat

LANES, STEPS = 8192, 100
LADDER = (1152, 8192)
HORNER = ((32, 8, 1), (43, 6, 45))  # (W, c, C) of a flat MSM and a ragged c_open
BASES = 1024  # random points the accumulate's entries cycle through


def _timeit(name: str, fn, dev, reps: int) -> dict:
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    print(f"{name:40s} warm {best * 1e3:9.2f} ms  (first {first:6.2f} s)", flush=True)
    return {"name": name, "warm_ms": best * 1e3, "first_s": first}


def run(device=DEFAULT, reps: int = 5, lanes: int = LANES, steps: int = STEPS,
        ladder=LADDER, horner=HORNER) -> list[dict]:
    """The rows above on ``device``."""
    dev = resolve(device)
    curve = bls12_381_g1(dev)
    spec = curve.fq.spec
    rows = []
    bases = rand_points_flat(curve, min(BASES, lanes * steps), 91)
    E = lanes * steps
    keys = torch.zeros(E, dtype=torch.int64, device=dev)  # one bucket a lane: every step adds
    pid = torch.arange(E, device=dev) % bases.x.shape[0]
    neg = torch.zeros(E, dtype=torch.bool, device=dev)
    rows.append(_timeit(f"{steps}x accumulate step [{lanes}]", lambda: cuda_g1.accumulate(
        spec, keys, pid, neg, bases, lanes, steps), dev, reps))

    acc = curve.double(rand_points_flat(curve, lanes, 92))
    q = rand_points_flat(curve, lanes, 93)

    def adds():
        a = acc
        for _ in range(100):
            a = curve.add(a, q)
        return a
    rows.append(_timeit(f"100x full add [{lanes}]", adds, dev, reps))

    g = curve.from_affine_ints([BLS12_381_G1_GEN])
    for m in ladder:
        pts = map_points(lambda a: a.expand(m, a.shape[-1]), g)
        sc = curve.fr.decode(curve.fr.random((m,), 7))
        rows.append(_timeit(f"scalar_mul ladder [{m}]", lambda: curve.scalar_mul(pts, sc),
                            dev, reps))

    for W, c, C in horner:
        tot = map_points(lambda a: a.reshape(W, C, a.shape[-1]),
                         rand_points_flat(curve, W * C, 94))
        rows.append(_timeit(f"horner W={W} c={c} C={C}",
                            lambda: cuda_g1.horner(spec, tot, c), dev, reps))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.device, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
