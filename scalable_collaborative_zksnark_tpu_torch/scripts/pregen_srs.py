"""Fill the benchmark-SRS disk cache for (n, l).

The port of the JAX package's ``scripts/pregen_srs.py``: it builds the
seeded random SRS of ``hyperplonk/params.benchmark_srs`` on the requested
device and writes it to ``--dir`` (default ``SCZK_SRS_CACHE``, else
``.srs_cache/`` at the root of the checkout), where later
``packed_proving_parameters`` calls of the same (n, l), with
``SCZK_SRS_CACHE`` set to that directory, load it.  Unlike the JAX script
it builds on the card unless ``--device cpu`` is given.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.pregen_srs --n 22 --l 8 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

from ..curves.g1 import bls12_381_g1
from ..device import DEFAULT, resolve, sync
from ..hyperplonk.params import cached_benchmark_srs, srs_cache_path
from ..pss.pss import PackedSharingParams

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".srs_cache"


def run(n: int, l: int, device=DEFAULT, seed: int = 1, cache_dir=None) -> dict:
    """Build (or load) and cache the SRS of (n, l) in ``cache_dir`` (default
    ``SCZK_SRS_CACHE``, else ``DEFAULT_DIR``): the file, its size, and the
    seconds it took."""
    dev = resolve(device)
    cache_dir = cache_dir or os.environ.get("SCZK_SRS_CACHE") or DEFAULT_DIR
    curve = bls12_381_g1(dev)
    pp = PackedSharingParams(curve.fr, l)
    path = srs_cache_path(curve, n, pp, seed, cache_dir)
    hit = path.exists()
    t0 = time.perf_counter()
    cached_benchmark_srs(curve, n, pp, seed, cache_dir)
    sync(dev)
    return {"n": n, "l": l, "path": str(path), "bytes": path.stat().st_size,
            "was_cached": hit, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=22)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--dir", default=None, help="cache directory")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.l, args.device, cache_dir=args.dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
