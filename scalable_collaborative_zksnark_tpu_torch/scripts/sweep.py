"""Benchmark sweeps of the port into a CSV.

The port of the JAX package's ``scripts/sweep.py`` (the reference's
``hack/bench_*.sh`` and ``read_data.ipynb``): one row for each (l, n) of
a suite, with the JAX script's columns (suite, n, l, mode, backend,
seconds, up_bytes, down_bytes; backend is the torch device type).  Every
time is the host clock between two synchronisations of the device:

* ``hyperplonk``: ``dhyperplonk`` at (n, l), the median of three proves
  after a warm-up (the JAX script's phased prove; the port has one form);
* ``sumcheck``: ``c_sumcheck_product`` on 2^n / l share evaluations a
  party, one run after a warm-up;
* ``poly_comm``: ``c_open`` of a 2^n / l share table on ``srs_random``;
* ``pss``: ``pack_from_public`` then ``unpack`` of 2^n field secrets (the
  seconds, after a warm-up), with one G1 pack and unpack of min(2^n, 256)
  points printed.

The bytes are those of party 0 in the timed run.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.sweep --suite hyperplonk --l 4 8 --n 10 12 14 --out sweep.csv
    python -m scalable_collaborative_zksnark_tpu_torch.scripts.sweep --suite sumcheck --l 8 --n 16 18 20
"""

from __future__ import annotations

import argparse
import csv
import statistics
import sys
import time

from ..curves import host_curve as hc
from ..curves.g1 import bls12_381_g1, map_points
from ..device import DEFAULT, resolve, sync
from ..fields.fr import get_field
from ..hyperplonk.collaborative import dhyperplonk
from ..hyperplonk.params import packed_proving_parameters
from ..mpc.net import PartyNet
from ..primitives.poly_comm import c_open, srs_random
from ..primitives.sumcheck import c_sumcheck_product
from ..pss.pss import PackedSharingParams

SUITES = ("hyperplonk", "sumcheck", "poly_comm", "pss")
COLUMNS = ("suite", "n", "l", "mode", "backend", "seconds", "up_bytes", "down_bytes")


def _timed(fn, dev) -> float:
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def _warm_then_timed(fn, net: PartyNet, dev) -> float:
    """One warm-up run, then one timed run whose bytes the net keeps."""
    fn()
    net.reset_comm()
    return _timed(fn, dev)


def run_one(suite: str, n: int, l: int, mode: str, dev) -> tuple:
    """(seconds, party 0's up bytes, its down bytes) of one cell."""
    net = PartyNet(8 * l, mode=mode)
    if suite == "hyperplonk":
        pk = packed_proving_parameters(n, l, net, device=dev)
        step = lambda: dhyperplonk(n, pk, net)  # noqa: E731
        step()
        runs = [_timed(step, dev) for _ in range(2)]
        net.reset_comm()
        runs.append(_timed(step, dev))
        dt = statistics.median(runs)
    elif suite == "sumcheck":
        F = get_field("bls12_381_fr", dev)
        pp = PackedSharingParams(F, l)
        P = net.local_parties
        f, g = F.random((P, (1 << n) // l), 1), F.random((P, (1 << n) // l), 2)
        ch = F.random((n + 4,), 3)
        dt = _warm_then_timed(lambda: c_sumcheck_product(pp, net, f, g, ch), net, dev)
    elif suite == "pss":
        # criterion parity (dist-primitive/benches/pss.rs): pack and unpack
        # of field vectors and G1 points at l; n = log2(secrets)
        F = get_field("bls12_381_fr", dev)
        pp = PackedSharingParams(F, l)
        M = 1 << n
        sec = F.random((M // l, l), 1)
        dt = _warm_then_timed(lambda: pp.unpack(pp.pack_from_public(sec)), net, dev)
        curve = bls12_381_g1(dev)
        m = min(M, 256)
        pts = map_points(lambda a: a.reshape(-1, l, a.shape[-1]),
                         curve.from_affine_ints([hc.G1_GEN] * m))
        # one run: on the CPU the plain ladders take seconds whatever the lanes
        dt_g = _timed(lambda: pp.unpack_group(curve, pp.pack_from_public_group(curve, pts)), dev)
        print(f"# pss l={l} n={n}: field pack+unpack {dt:.4f}s, "
              f"G1 pack+unpack ({m} pts) {dt_g:.4f}s", file=sys.stderr)
        return dt, 0, 0
    elif suite == "poly_comm":
        curve = bls12_381_g1(dev)
        F = curve.fr
        pp = PackedSharingParams(F, l)
        srs = srs_random(curve, n, 7, packed_parties=pp.n, max_level=-1)
        pe = F.random((net.local_parties, (1 << n) // l), 1)
        pt = F.random((n + 2,), 2)
        dt = _warm_then_timed(lambda: c_open(srs, pp, net, pe, pt), net, dev)
    else:
        raise ValueError(f"unknown suite {suite}")
    up, down = net.comm(0)
    return dt, up, down


def run(suite: str, ls, ns, mode: str = "leader", device=DEFAULT, out=None) -> list[dict]:
    """Every (l, n) cell of ``suite``: the rows, also written to ``out`` as
    a CSV when it is given."""
    dev = resolve(device)
    rows = []
    for l in ls:
        for n in ns:
            dt, up, down = run_one(suite, n, l, mode, dev)
            row = dict(zip(COLUMNS, (suite, n, l, mode, dev.type, dt, up, down)))
            rows.append(row)
            print(row, flush=True)
    if out:
        with open(out, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=COLUMNS)
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {out}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--suite", choices=SUITES, default="sumcheck")
    ap.add_argument("--l", type=int, nargs="+", default=[2])
    ap.add_argument("--n", type=int, nargs="+", default=[10])
    ap.add_argument("--mode", choices=("sim", "leader"), default="leader")
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="CSV output path")
    args = ap.parse_args(argv)
    run(args.suite, args.l, args.n, args.mode, args.device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
