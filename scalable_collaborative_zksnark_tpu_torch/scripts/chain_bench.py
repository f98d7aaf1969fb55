"""Horner, bucket-serial and the Fq product chain, timed on their own.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.chain_bench [--device cuda]

Prints one JSON object:

* ``horner_ms``: ``cuda_g1.horner`` on seeded random window totals (Z != 1)
  at each ``--horner`` shape W,C,c (default: the (16, 8) prove's
  ``c_commit`` shape 32,3,8 and its ``c_open`` chain's 43,39,6);
* ``bucket_serial_ms``: ``cuda_g1.bucket_serial`` on seeded random buckets
  at each ``--bucket`` shape K,M (default 33,1677, the ``c_open`` chain's),
  with the default number of segments and, where the package segments
  the buckets, with each of ``--segments``;
* ``fq_chain_us``: one Fq product in a one-thread chain, ``fr.cuh``'s
  ``fmul`` and, where the package has it, ``fq_chain.cuh``'s product;
* ``prove_median_s``: the (16, 8) leader-mode prove through ``bench.run``
  (``--prove-repeat`` proves after a warm-up; ``--no-prove`` skips it);
* with ``--sass``, ``sass_ops``: the instructions of the one-thread chain
  kernels' SASS by opcode (``cuobjdump -sass`` of the built libraries),
  what one product compiles to.

Kernel times are medians of ``--reps`` runs, each between CUDA events
after a warm-up (host clock on the CPU).  The script reaches only entry
points that the port has had since its G1 slice, plus the newer ones when
they are there, so a copy of it times an older checkout of the port just
as well: two versions can be compared in one call on one card.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import re
import statistics
import subprocess
import time

import torch

from .. import bench, cuda_build
from ..curves import cuda_g1
from ..curves.g1 import bls12_381_g1, map_points
from ..device import DEFAULT, resolve, sync
from ..primitives.poly_comm import rand_points_flat


def _ms(fn, dev: torch.device, reps: int) -> float:
    fn()
    sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _points(curve, shape, seed: int):
    n = 1
    for d in shape:
        n *= d
    pts = curve.double(rand_points_flat(curve, n, seed))  # Z != 1
    return map_points(lambda a: a.reshape(tuple(shape) + a.shape[-1:]), pts)


def sass_ops(lib: str, kernel: str) -> dict:
    """Opcode counts of ``kernel``'s SASS in the shared library ``lib``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts.most_common())


def _card(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def run(device=DEFAULT, horner=((32, 3, 8), (43, 39, 6)), buckets=((33, 1677),),
        segments=(1, 2, 4, 8), reps: int = 10, prove_repeat: int = 5, sass: bool = False) -> dict:
    dev = resolve(device)
    curve = bls12_381_g1(dev)
    spec = curve.fq.spec
    out = {"card": _card(dev), "horner_ms": {}, "bucket_serial_ms": {}, "fq_chain_us": {}}
    for k, (W, C, c) in enumerate(horner):
        tot = _points(curve, (W, C), 81 + k)
        out["horner_ms"][f"{W},{C},{c}"] = _ms(lambda: cuda_g1.horner(spec, tot, c), dev, reps)
    segmented = "segments" in inspect.signature(cuda_g1.bucket_serial).parameters
    for k, (K, M) in enumerate(buckets):
        bk = _points(curve, (K, M), 91 + k)
        row = {"default": _ms(lambda: cuda_g1.bucket_serial(spec, bk), dev, reps)}
        if segmented:
            row["default_segments"] = cuda_g1.bucket_segments(K, M)
            for S in segments:
                row[f"S={S}"] = _ms(lambda: cuda_g1.bucket_serial(spec, bk, S), dev, reps)
        out["bucket_serial_ms"][f"{K},{M}"] = row
    if dev.type == "cuda":
        xy = curve.fq.random((2,), 71)
        n = 1 << 16
        for name in ("fq_mul_chain", "fq_mul_cc_chain"):
            probe = getattr(cuda_g1, name, None)
            if probe is not None:
                step = (_ms(lambda: probe(spec, xy, 2 * n), dev, 3)
                        - _ms(lambda: probe(spec, xy, n), dev, 3)) / n
                out["fq_chain_us"][name] = step * 1e3
    if sass:
        probes = (("g1", "fq_mul_chain_kernel"), ("g1_chain", "fq_mul_cc_chain_kernel"))
        out["sass_ops"] = {kernel: sass_ops(str(cuda_build._target(lib)), kernel)
                           for lib, kernel in probes if cuda_build._target(lib).exists()}
    if prove_repeat:
        report, _ = bench.run(16, 8, dev, repeat=prove_repeat)
        out.update(prove_median_s=report["value"], prove_runs_s=report["runs"],
                   prove_digest=report["digest"], prove_conformance=report["conformance"])
    return out


def _shapes(text: str, n: int):
    shapes = [tuple(int(v) for v in s.split(",")) for s in text.split(";")]
    if any(len(s) != n for s in shapes):
        raise argparse.ArgumentTypeError(f"want shapes of {n} numbers separated by ';'")
    return shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT)
    ap.add_argument("--horner", type=lambda t: _shapes(t, 3), default=[(32, 3, 8), (43, 39, 6)],
                    help="W,C,c shapes separated by ';'")
    ap.add_argument("--bucket", type=lambda t: _shapes(t, 2), default=[(33, 1677)],
                    help="K,M shapes separated by ';'")
    ap.add_argument("--segments", type=lambda t: [int(v) for v in t.split(",")],
                    default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--prove-repeat", type=int, default=5)
    ap.add_argument("--no-prove", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.horner, args.bucket, args.segments, args.reps,
                         0 if args.no_prove else args.prove_repeat, args.sass)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
