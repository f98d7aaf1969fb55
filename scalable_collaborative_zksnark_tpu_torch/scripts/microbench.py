"""Kernel micro-benchmarks: field product rate, MSM time, product sumcheck.

The port of the JAX package's ``scripts/microbench.py``.  Prints one JSON
line per metric, with the JAX script's names:

* ``fr_mul_Mmul_per_s``: 8 chained squarings of 2^20 elements
  (``Field.mul``, ``csrc/fr.cu``);
* ``msm_2e15_c{c}_s``: ``msm`` of 2^15 affine points (multiples of the
  generator by 32-bit scalars) by full scalars, for each ``--msm-c`` (the
  dense core replaces c by its cost model, as the JAX package's default
  does, so the label is the request); ``vs_baseline`` against the
  reference's local share-MSM, 0.0225 s (BASELINE.md);
* ``sumcheck_product_2e15_s``: ``sumcheck_product`` on one 2^15 pair.

Each time is the best of ``--repeat`` runs after a warm-up, between two
``torch.cuda.synchronize`` calls:

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.microbench [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..curves.g1 import BLS12_381_G1_GEN, bls12_381_g1, map_points
from ..device import DEFAULT, resolve, sync
from ..fields.fr import get_field
from ..primitives.msm import msm
from ..primitives.sumcheck import sumcheck_product

MSM_BASELINE_S = 0.0225


def _best_s(fn, dev: torch.device, repeat: int) -> float:
    fn()
    sync(dev)
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _emit(metric: str, value: float, unit: str, baseline: float | None = None) -> dict:
    rec = {"metric": metric, "value": value, "unit": unit}
    if baseline is not None:
        rec["vs_baseline"] = baseline / value
    print(json.dumps(rec), flush=True)
    return rec


def run(device=DEFAULT, mul_m: int = 1 << 20, msm_n: int = 1 << 15, msm_c=(8, 10, 12),
        sc_m: int = 1 << 15, repeat: int = 3, skip=()) -> list[dict]:
    dev = resolve(device)
    F = get_field("bls12_381_fr", dev)
    recs = []
    if "mul" not in skip:
        a, K = F.random((mul_m,), 5), 8

        def mul_chain():
            x = a
            for _ in range(K):
                x = F.mul(x, x)
            return x

        dt = _best_s(mul_chain, dev, repeat)
        recs.append(_emit("fr_mul_Mmul_per_s", mul_m * K / dt / 1e6, "Mmul/s"))
    if "msm" not in skip:
        C = bls12_381_g1(dev)
        g = C.from_affine_ints([BLS12_381_G1_GEN])
        base = map_points(lambda x: x.expand((msm_n,) + x.shape[1:]), g)
        ks = np.random.RandomState(3).randint(1, 1 << 16, size=(msm_n, 2)).astype(np.int32)
        pts = C.normalize(C.scalar_mul(base, torch.from_numpy(ks).to(dev)))
        scal = F.decode(F.random((msm_n,), 7))
        for c in msm_c:
            dt = _best_s(lambda c=c: msm(C, pts, scal, c=c, affine=True), dev, repeat)
            recs.append(_emit(f"msm_2e{msm_n.bit_length() - 1}_c{c}_s", dt, "s", MSM_BASELINE_S))
    if "sc" not in skip:
        f, gt = F.random((1, sc_m), 11), F.random((1, sc_m), 12)
        ch = F.random((sc_m.bit_length() + 2,), 13)
        dt = _best_s(lambda: sumcheck_product(F, f, gt, ch), dev, repeat)
        recs.append(_emit(f"sumcheck_product_2e{sc_m.bit_length() - 1}_s", dt, "s"))
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--mul-m", type=int, default=1 << 20, help="elements for fr.mul")
    ap.add_argument("--msm-n", type=int, default=1 << 15)
    ap.add_argument("--msm-c", type=int, nargs="*", default=[8, 10, 12])
    ap.add_argument("--sc-m", type=int, default=1 << 15, help="sumcheck table size")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--skip", nargs="*", default=[], choices=["mul", "msm", "sc"])
    args = ap.parse_args(argv)
    run(args.device, args.mul_m, args.msm_n, args.msm_c, args.sc_m, args.repeat, args.skip)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
