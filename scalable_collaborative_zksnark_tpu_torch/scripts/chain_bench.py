"""Point add, the masked add, the scalar ladder, the accumulate, Horner,
bucket-serial and the Fq product chain, timed on their own.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.chain_bench [--device cuda]

Prints one JSON object:

* ``add_ms``: ``cuda_g1.add`` on seeded random points (Z != 1) at each
  ``--add`` lane count (default 3, 96 and 8,192, the commonest shapes of
  the (16, 8) prove): ``device``, the device time a call
  (``torch.profiler``, every kernel the call launches; null on the CPU),
  and ``events``, the time between CUDA events around one call, which at
  a few lanes is the host's time for the call;
* ``masked_ms``: ``cuda_g1.add_masked`` on seeded random points (Z != 1)
  and affine ones under a seeded random mask, at each ``--masked`` item
  ``M`` or ``M:F`` (M lanes, a share F of them masked, default 0.5;
  default: the non-dense (16, 8) prove's four commonest lane counts at
  their mean masked share, and 65,542 lanes half masked), ``device`` and
  ``events`` as for ``add_ms``;
* ``ladder_ms``: ``cuda_g1.scalar_mul`` on seeded random points (Z != 1)
  and random scalars at each ``--ladder`` item ``M`` or ``MxL`` (M lanes
  of L 16-bit limbs, default 16, the full width of Fr; default: the
  (16, 8) prove's shapes, 14, 21 and 192 lanes, and 1,027),
  ``device`` and ``events`` as for ``add_ms``;
* ``accumulate_ms``: ``cuda_g1.accumulate`` on the call that an MSM of
  seeded bases and scalars makes, at each ``--accumulate`` shape
  (``device`` and ``events`` as for ``add_ms``; the wrapper's call also
  zeroes and reads back its repair count):
  ``msm:N,B`` (``msm`` of B scalar rows over N bases; default 8192,3, the
  prove's ``c_commit`` shape (a)) or ``ragged:TOP,B`` (``msm_ragged`` over
  levels TOP, TOP/2, .. 1, batch B; default 4096,3, its ``c_open`` chain
  (c)); each row gives the call's (E, T, steps).  The MSM stops at that
  call;
* ``horner_ms``: ``cuda_g1.horner`` on seeded random window totals (Z != 1)
  at each ``--horner`` shape W,C,c (default: the (16, 8) prove's
  ``c_commit`` shape 32,3,8 and its ``c_open`` chain's 43,39,6);
* ``bucket_serial_ms``: ``cuda_g1.bucket_serial`` on seeded random buckets
  at each ``--bucket`` shape K,M (default 33,1677, the ``c_open`` chain's),
  with the default number of segments and, where the package segments
  the buckets, with each of ``--segments``;
* ``fq_chain_us``: one Fq product in a one-thread chain, ``fr.cuh``'s
  ``fmul`` and, where the package has it, ``fq_chain.cuh``'s product;
* ``phase_ms``: ``cuda_sumcheck.product_phase`` on seeded random Fr tables
  at each ``--phase`` shape B,M (default 6,8192, the (16, 8) prove's gate
  identity, and the reference envelope's 1,2097152 and 1,33554432),
  on contiguous tables (no input copy), ``device`` (every launch of the
  call; null where the profile holds another count of launches than the
  calls made) and ``events`` as for ``add_ms``;
* ``fr_chain_us``: where the package has the probes, one Fr product in a
  one-thread chain, ``fmul<8>`` and the carry-chain ``fr_mul_cc``;
* ``elementwise_ms``: ``cuda_fr.mul``, ``add`` and ``sub`` on seeded
  random operands (contiguous) at each op's three commonest shapes in the
  (16, 8) prove (Fr; ``--elementwise`` adds ``M`` elements, default 2^20,
  in Fr and Fq), ``device`` (every kernel and copy the call makes; null
  where the profile holds none) and ``events`` as for ``add_ms``;
* ``point_ms``: ``cuda_g1.add_mixed`` (an affine right operand) and
  ``cuda_g1.double`` on ``--points`` seeded random points (default
  65,542), ``device`` and ``events`` as for ``add_ms``;
* ``empty_launch_ms``: on the card, the device time of one empty kernel
  launch (``device`` as for ``add_ms``);
* ``stage_ms``: on the card, the device time a launch of the elementwise
  kernel (``cuda_fr.run_binary``) on seeded random contiguous operands,
  ``small`` and ``staged`` (``null`` where the profile holds none), for
  each op at its three commonest (16, 8) prove shapes (Fr) and at each
  ``--stage`` size ``M`` (Fr and Fq): where staging starts to pay, which
  ``cuda_fr.STAGE_MIN`` is taken from;
* ``prove_median_s``: the (16, 8) leader-mode prove through ``bench.run``
  (``--prove-repeat`` proves after a warm-up; ``--no-prove`` skips it),
  and ``prove_fr_copies``: the operands the elementwise wrapper
  materialised in one more dense prove (``cuda_fr.copies``);
* with ``--sass``, ``sass_ops``: the instructions of the one-thread chain
  kernels' SASS by opcode (``cuobjdump -sass`` of the built libraries),
  what one product compiles to.

Kernel times are medians of ``--reps`` runs, each between CUDA events
after a warm-up (host clock on the CPU), unless a row says otherwise.  The script reaches only entry
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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import bench, cuda_build
from ..curves import cuda_g1
from ..curves.g1 import bls12_381_g1, map_points
from ..device import DEFAULT, resolve, sync
from ..fields import cuda_fr
from ..fields.fr import get_field
from ..hyperplonk.collaborative import dhyperplonk
from ..primitives import cuda_sumcheck, msm
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


def _device_ms(fn, dev: torch.device, reps: int, launches: int = 0):
    """Device milliseconds a run of ``fn``: the own device time of every
    kernel and copy it launches over ``reps`` runs under ``torch.profiler``
    (after a warm-up), over ``reps``; None on the CPU, when the profiler
    reports no device time, or, given the ``launches`` a run makes, when it
    reports another count (a session that dropped launches would read too
    fast).  Only events on the card count: a host-side op reports its
    kernels' time as its own too."""
    if dev.type != "cuda":
        return None
    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync(dev)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if launches and sum(e.count for e in events) != reps * launches:
        return None
    total = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                for e in events)
    return total / 1e3 / reps if total > 0 else None


class _Kept(Exception):
    """Stops an MSM once its accumulate call is kept."""


def accumulate_call(curve, kind: str, n: int, batch: int, seed: int = 101) -> tuple:
    """The arguments of the first ``cuda_g1.accumulate`` call that ``msm``
    (``kind`` "msm": ``batch`` rows of scalars over ``n`` bases) or
    ``msm_ragged`` ("ragged": levels n, n/2, .. 1, batch ``batch``) makes
    on seeded random bases and scalars."""
    F = curve.fr
    if kind == "msm":
        bases = rand_points_flat(curve, n, seed)
        scal = F.decode(F.random((batch, n), seed + 1))
        run = lambda: msm.msm(curve, bases, scal)  # noqa: E731
    elif kind == "ragged":
        sizes = [n >> k for k in range(n.bit_length())]
        flat = rand_points_flat(curve, sum(sizes), seed)
        offs = [sum(sizes[:k]) for k in range(len(sizes))]
        levels = [map_points(lambda a, o=o, k=k: a[o:o + k], flat) for o, k in zip(offs, sizes)]
        scal = F.decode(F.random((batch, sum(sizes)), seed + 1))
        chunks = list(torch.split(scal, sizes, dim=1))
        run = lambda: msm.msm_ragged(curve, levels, chunks)  # noqa: E731
    else:
        raise ValueError(f"unknown MSM kind {kind!r}: want msm or ragged")
    kept = []

    class _Keep:
        def __getattr__(self, name):
            return getattr(cuda_g1, name)

        @staticmethod
        def accumulate(*args):
            kept.append(args)
            raise _Kept

    msm.cuda_g1 = _Keep()
    try:
        run()
    except _Kept:
        pass
    finally:
        msm.cuda_g1 = cuda_g1
    if not kept:
        raise ValueError(f"{kind} {n},{batch} makes no accumulate call (a naive MSM?)")
    return kept[0]


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


ADD_LANES = (3, 96, 8192)
# the non-dense (16, 8) prove's four commonest add_masked lane counts, each
# with its calls' mean masked share, then 65,542 lanes half masked
MASKED = ((107328, 0.0162), (165120, 0.0164), (33024, 0.0175), (536640, 0.0063), (65542, 0.5))
# the (16, 8) prove's ladder shapes, then 1,027 lanes
LADDERS = ((14, 16), (21, 16), (192, 16), (1027, 16))
ACCUMULATE_CALLS = (("msm", 8192, 3), ("ragged", 4096, 3))
# the (16, 8) prove's three commonest (a, b) batch shapes of each Fr op
ELEMENTWISE_SHAPES = {"mul": (((1, 1), (1, 1)), ((1, 3, 1), ()), ((10, 3, 1), ())),
                      "add": (((10, 3, 1),) * 2, ((1, 3, 1),) * 2, ((1, 3, 2),) * 2),
                      "sub": (((1, 3, 2),) * 2, ((1, 3, 1),) * 2, ((1, 3, 4),) * 2)}
ELEMENTWISE_LARGE = (1 << 20,)
STAGE_SIZES = (1, 64, 96, 128, 160, 192, 256, 512, 1024, 2048, 4096, 8192, 16384, 65536)
POINTS = 65542
PHASES = ((6, 1 << 13), (1, 1 << 21), (1, 1 << 25))


def _timed(call, dev: torch.device, reps: int, launches: int = 0) -> dict:
    return {"device": _device_ms(call, dev, reps, launches), "events": _ms(call, dev, reps)}


def run(device=DEFAULT, horner=((32, 3, 8), (43, 39, 6)), buckets=((33, 1677),),
        segments=(1, 2, 4, 8), reps: int = 10, prove_repeat: int = 5, sass: bool = False,
        add_lanes=ADD_LANES, accumulate=ACCUMULATE_CALLS, masked=MASKED,
        ladders=LADDERS, phases=PHASES, elementwise=ELEMENTWISE_LARGE,
        points: int = POINTS, stage=STAGE_SIZES) -> dict:
    dev = resolve(device)
    curve = bls12_381_g1(dev)
    spec = curve.fq.spec
    out = {"card": _card(dev), "add_ms": {}, "masked_ms": {}, "ladder_ms": {},
           "accumulate_ms": {}, "horner_ms": {}, "bucket_serial_ms": {}, "fq_chain_us": {},
           "phase_ms": {}, "fr_chain_us": {}, "elementwise_ms": {}, "point_ms": {},
           "stage_ms": {}}
    Fr = get_field("bls12_381_fr", device=dev)
    Fq = get_field("bls12_381_fq", device=dev)
    for op, pairs in ELEMENTWISE_SHAPES.items():
        kern = getattr(cuda_fr, op)
        cases = [(Fr, sa, sb) for sa, sb in pairs]
        cases += [(F, (m,), (m,)) for m in elementwise for F in (Fr, Fq)]
        for k, (F, sa, sb) in enumerate(cases):
            a = F.random(sa, 151 + 2 * k).contiguous()
            b = F.random(sb, 152 + 2 * k).contiguous()
            out["elementwise_ms"][f"{F.spec.name} {op} {list(sa)}x{list(sb)}"] = _timed(
                lambda: kern(F.spec, a, b), dev, reps)
    if points:
        p1, p2 = _points(curve, (points,), 161), rand_points_flat(curve, points, 162)
        out["point_ms"]["add_mixed"] = _timed(lambda: cuda_g1.add_mixed(spec, p1, p2), dev, reps)
        out["point_ms"]["double"] = _timed(lambda: cuda_g1.double(spec, p1), dev, reps)
    if dev.type == "cuda":
        out["empty_launch_ms"] = _device_ms(lambda: cuda_fr.empty_launch(dev), dev, reps, 1)
        out["stage_ms"] = stage_rows(Fr, Fq, stage, dev, reps)
    for k, (B, M) in enumerate(phases):  # contiguous tables: the call launches the phase alone
        f = Fr.random((B, M), 131 + 2 * k).contiguous()
        g = Fr.random((B, M), 132 + 2 * k).contiguous()
        ch = Fr.random((M.bit_length(),), 141 + k).contiguous()
        call = lambda: cuda_sumcheck.product_phase(Fr, f, g, ch, 0)  # noqa: E731
        before = cuda_sumcheck.product_phase.launches
        call()
        out["phase_ms"][f"{B},{M}"] = _timed(call, dev, reps,
                                             cuda_sumcheck.product_phase.launches - before)
    for k, m in enumerate(add_lanes):
        p1, p2 = _points(curve, (m,), 61 + 2 * k), _points(curve, (m,), 62 + 2 * k)
        out["add_ms"][str(m)] = _timed(lambda: cuda_g1.add(spec, p1, p2), dev, reps)
    for k, (m, share) in enumerate(masked):
        p1, p2 = _points(curve, (m,), 111 + 2 * k), rand_points_flat(curve, m, 112 + 2 * k)
        gen = torch.Generator().manual_seed(113 + k)
        mask = (torch.rand(m, generator=gen) < share).to(dev)
        out["masked_ms"][f"{m}:{share}"] = _timed(
            lambda: cuda_g1.add_masked(spec, p1, p2, mask), dev, reps)
    for k, (m, L) in enumerate(ladders):
        pts = _points(curve, (m,), 121 + k)
        gen = torch.Generator().manual_seed(122 + k)
        sc = torch.randint(0, 1 << 16, (m, L), generator=gen, dtype=torch.int32).to(dev)
        out["ladder_ms"][f"{m}x{L}"] = _timed(lambda: cuda_g1.scalar_mul(spec, pts, sc), dev,
                                               reps)
    for kind, n, batch in accumulate:
        args = accumulate_call(curve, kind, n, batch)
        E, T, NB = args[1].shape[0], args[5], args[6]
        out["accumulate_ms"][f"{kind}:{n},{batch}"] = {
            "shape": [E, T, -(-E // T), NB],
            **_timed(lambda: cuda_g1.accumulate(*args), dev, reps)}
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
        if hasattr(cuda_sumcheck, "fr_mul_chain"):
            fxy = Fr.random((2,), 72)
            for name, cc in (("fmul", False), ("fr_mul_cc", True)):
                probe = lambda k, cc=cc: cuda_sumcheck.fr_mul_chain(Fr.spec, fxy, k, cc)  # noqa: E731
                step = (_ms(lambda: probe(2 * n), dev, 3) - _ms(lambda: probe(n), dev, 3)) / n
                out["fr_chain_us"][name] = step * 1e3
    if sass:
        probes = (("g1", "fq_mul_chain_kernel"), ("g1_chain", "fq_mul_cc_chain_kernel"))
        out["sass_ops"] = {kernel: sass_ops(str(cuda_build._target(lib)), kernel)
                           for lib, kernel in probes if cuda_build._target(lib).exists()}
    if prove_repeat:
        report, (pk, net, _) = bench.run(16, 8, dev, repeat=prove_repeat)
        out.update(prove_median_s=report["value"], prove_runs_s=report["runs"],
                   prove_digest=report["digest"], prove_conformance=report["conformance"],
                   prove_fr_copies=prove_copies(pk, net))
    return out


def prove_copies(pk, net) -> int:
    """Operands the elementwise wrapper materialised over one dense (16, 8)
    prove (``cuda_fr.copies``)."""
    before = cuda_fr.copies
    dhyperplonk(16, pk, net)
    return cuda_fr.copies - before


def stage_rows(Fr, Fq, sizes, dev: torch.device, reps: int) -> dict:
    """``stage_ms``: each op's small and staged launch at its commonest
    prove shapes (Fr) and at each of ``sizes`` (Fr and Fq)."""
    lib = cuda_build.library("fr", cuda_fr._SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = {}
    for op, pairs in ELEMENTWISE_SHAPES.items():
        cases = [(Fr, sa, sb) for sa, sb in pairs]
        cases += [(F, (m,), (m,)) for m in sizes for F in (Fr, Fq)]
        for k, (F, sa, sb) in enumerate(cases):
            a = F.random(sa, 171 + 2 * k).contiguous()
            b = F.random(sb, 172 + 2 * k).contiguous()
            rows[f"{F.spec.name} {op} {list(sa)}x{list(sb)}"] = {
                how: _device_ms(lambda staged=staged: cuda_fr.run_binary(
                    lib, op, F.spec, a, b, stream, staged), dev, reps, 1)
                for how, staged in (("small", False), ("staged", True))}
    return rows


def _shapes(text: str, n: int):
    shapes = [tuple(int(v) for v in s.split(",")) for s in filter(None, text.split(";"))]
    if any(len(s) != n for s in shapes):
        raise argparse.ArgumentTypeError(f"want shapes of {n} numbers separated by ';'")
    return shapes


def _items(text: str, sep: str, default, kind=int) -> list:
    """``A`` or ``A<sep>B`` items separated by ',' as (A, B), B ``default``
    where it is left out (an empty text: none)."""
    items = []
    for item in filter(None, text.split(",")):
        a, _, b = item.partition(sep)
        items.append((int(a), kind(b) if b else default))
    return items


def _msm_calls(text: str):
    """``kind:N,B`` shapes separated by ';' (an empty text: none)."""
    calls = []
    for item in filter(None, text.split(";")):
        kind, _, shape = item.partition(":")
        if kind not in ("msm", "ragged"):
            raise argparse.ArgumentTypeError(f"{item!r}: want msm:N,B or ragged:TOP,B")
        calls.append((kind, *_shapes(shape, 2)[0]))
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT)
    ap.add_argument("--horner", type=lambda t: _shapes(t, 3), default=[(32, 3, 8), (43, 39, 6)],
                    help="W,C,c shapes separated by ';'")
    ap.add_argument("--bucket", type=lambda t: _shapes(t, 2), default=[(33, 1677)],
                    help="K,M shapes separated by ';'")
    ap.add_argument("--segments", type=lambda t: [int(v) for v in t.split(",")],
                    default=[1, 2, 4, 8])
    ap.add_argument("--add", type=lambda t: [int(v) for v in t.split(",") if v],
                    default=list(ADD_LANES), help="lane counts of point add, separated by ','")
    ap.add_argument("--masked", type=lambda t: _items(t, ":", 0.5, float), default=list(MASKED),
                    help="add_masked lanes M or M:F (a share F masked), separated by ','")
    ap.add_argument("--ladder", type=lambda t: _items(t, "x", 16), default=list(LADDERS),
                    help="ladder lanes M or MxL (L 16-bit scalar limbs), separated by ','")
    ap.add_argument("--accumulate", type=_msm_calls, default=list(ACCUMULATE_CALLS),
                    help="MSM calls whose accumulate is timed: msm:N,B or ragged:TOP,B, "
                         "separated by ';'")
    ap.add_argument("--phase", type=lambda t: _shapes(t, 2), default=list(PHASES),
                    help="B,M phase shapes separated by ';'")
    ap.add_argument("--elementwise", type=lambda t: [int(v) for v in t.split(",") if v],
                    default=list(ELEMENTWISE_LARGE),
                    help="elements M of the Fr and Fq ops' large rows, separated by ','")
    ap.add_argument("--points", type=int, default=POINTS,
                    help="points of the add_mixed and double rows (0: none)")
    ap.add_argument("--stage", type=lambda t: [int(v) for v in t.split(",") if v],
                    default=list(STAGE_SIZES),
                    help="elements M of the small-against-staged rows, separated by ','")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--prove-repeat", type=int, default=5)
    ap.add_argument("--no-prove", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.horner, args.bucket, args.segments, args.reps,
                         0 if args.no_prove else args.prove_repeat, args.sass, args.add,
                         args.accumulate, args.masked, args.ladder, args.phase,
                         args.elementwise, args.points, args.stage)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
