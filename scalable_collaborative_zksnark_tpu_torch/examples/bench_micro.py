"""Micro-benchmarks of the hot kernels: field ops, group law, MSM, fold.

The port of the JAX package's ``examples/bench_micro.py``: per-op wall
time (best of three after a warm-up, between two ``torch.cuda.synchronize``
calls) and the derived rate on the chosen device, for ``Field.add``,
``Field.mul`` and ``batch_inv`` at 2^m elements, one product-sumcheck
round (``_rounds_product``, one round), point ``add`` and the scalar
ladder at 2^min(m, 16) points, and ``msm`` at 2^12, 2^14 and 2^16 points
with c = 4 and 8 (the dense core's cost model picks its own width):

    python -m scalable_collaborative_zksnark_tpu_torch.examples.bench_micro --m 20 [--device cuda]
"""

from __future__ import annotations

import time

import torch

from ..curves.g1 import BLS12_381_G1_GEN, bls12_381_g1, map_points
from ..device import sync
from ..fields.fr import get_field
from ..primitives.msm import msm
from ..primitives.sumcheck import _rounds_product
from .common import base_parser, setup


def timeit(fn, dev: torch.device, reps: int = 3) -> float:
    """Best wall seconds of ``reps`` synchronised runs after a warm-up."""
    fn()
    sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def run(m: int, dev: torch.device) -> dict:
    """Print one line per op and return {op: seconds}."""
    curve = bls12_381_g1(dev)
    F = get_field("bls12_381_fr", dev)
    M = 1 << m
    a, b = F.random((M,), 1), F.random((M,), 2)
    out = {}

    def show(key, dt, line):
        out[key] = dt
        print(line, flush=True)

    dt = timeit(lambda: F.add(a, b), dev)
    show("fr_add", dt, f"fr.add   [2^{m}]: {dt * 1e3:8.3f} ms  ({M / dt / 1e9:.2f} Gop/s)")
    dt = timeit(lambda: F.mul(a, b), dev)
    show("fr_mul", dt, f"fr.mul   [2^{m}]: {dt * 1e3:8.3f} ms  ({M / dt / 1e6:.1f} Mmul/s)")
    dt = timeit(lambda: F.batch_inv(a), dev)
    show("fr_binv", dt, f"fr.binv  [2^{m}]: {dt * 1e3:8.3f} ms  ({M / dt / 1e6:.1f} Minv/s)")

    ch = F.random((1,), 3)  # one product-sumcheck round
    dt = timeit(lambda: _rounds_product(F, a, b, ch, 0, 1)[0][0], dev)
    show("sumcheck_round", dt, f"sumcheck product round [2^{m}]: {dt * 1e3:8.3f} ms")

    mg = min(m, 16)
    Mg = 1 << mg
    g = curve.from_affine_ints([BLS12_381_G1_GEN])
    pts = map_points(lambda x: x.expand((Mg,) + x.shape[1:]), g)
    dt = timeit(lambda: curve.add(pts, pts), dev)
    show("g1_add", dt, f"g1.add   [2^{mg}]: {dt * 1e3:8.3f} ms  ({Mg / dt / 1e6:.2f} Madd/s)")
    ks = F.decode(F.random((Mg,), 4))
    dt = timeit(lambda: curve.scalar_mul(pts, ks), dev)
    show("g1_smul", dt, f"g1.smul  [2^{mg}]: {dt * 1e3:8.3f} ms")

    for mm in (12, 14, 16):
        if mm > m:
            break
        Mm = 1 << mm
        ptsm = map_points(lambda x: x.expand((Mm,) + x.shape[1:]), g)
        ksm = F.decode(F.random((Mm,), 5))
        for c in (4, 8):
            dt = timeit(lambda c=c: msm(curve, ptsm, ksm, c=c), dev)
            show(f"msm_2e{mm}_c{c}", dt, f"msm      [2^{mm}] c={c}: {dt * 1e3:8.3f} ms")
    return out


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--m", type=int, default=20, help="log2 elements for field ops")
    args = ap.parse_args(argv)
    run(args.m, setup(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
