"""Per-party prove time of the collaborative HyperPlonk prover on the port.

    python -m scalable_collaborative_zksnark_tpu_torch.bench --n 16 --l 8 [--device cuda] [--repeat 3]
    python -m scalable_collaborative_zksnark_tpu_torch.bench --conformance [--device cuda]
    python -m scalable_collaborative_zksnark_tpu_torch.bench --smoke [--device cpu]
    python -m scalable_collaborative_zksnark_tpu_torch.bench --trace DIR

Builds the seeded inputs and SRS (``packed_proving_parameters``), runs one
warm-up ``dhyperplonk`` prove in leader mode (one party's full compute,
the others' bytes counted), then ``--repeat`` proves, each between two
synchronisations, and one more with every ``timed`` span synchronised for
the split by step.  It prints one JSON line: the median prove time, the
runs, the first allocation on the device and the setup time, the per-party comm and rounds of one prove, the
split, and ``conformance``: the last prove's canonical digest against the
pins of the JAX package's ``bench.py``, made on the CPU.
``SCZK_MSM_DENSE=0`` selects the non-dense MSM cores, which prove the
same digest.

``--conformance`` proves only the pinned configurations of at most
``CONFORMANCE_PROVE_MAX_N`` variables, (6, 1), on the requested device and
prints one PASS/FAIL JSON line (exit 1 on FAIL), as the JAX package's
``bench.py --conformance`` does.  ``--trace DIR`` writes a
``torch.profiler`` trace of the timed proves into DIR
(``bench_trace.json``, Chrome's trace format).  ``--smoke`` proves n = 4,
l = 1 on the requested device: the card unless ``--device cpu`` is
given, never the CPU on its own.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .device import DEFAULT, resolve, sync
from .hyperplonk.collaborative import dhyperplonk
from .hyperplonk.params import packed_proving_parameters
from .mpc.net import PartyNet
from .utils import timer
from .utils.digest import proof_digest

# Canonical digests of the (n, l) leader-mode prove, from the JAX package
# on the CPU (its bench.py CONFORMANCE_PIN).
PINS = {
    (6, 1): 0x0D8B55994DD236A9,
    (16, 8): 0x8D7A4D5DE7FF827B,
}
SPANS = ("Commit", "Gate identity", "Wire identity", "Open")
CONFORMANCE_PROVE_MAX_N = 8  # --conformance proves the pinned configurations up to here
SMOKE = (4, 1)  # (n, l) of --smoke
TRACE_FILE = "bench_trace.json"


def pin_verdict(n: int, l: int, digest: int) -> str:
    pin = PINS.get((n, l))
    if pin is None:
        return f"no-pin (digest 0x{digest:016x})"
    return "pass" if digest == pin else f"fail (0x{digest:016x} != 0x{pin:016x})"


def _trace(dev: torch.device, trace_dir):
    """A ``torch.profiler`` session (host and, on the card, CUDA activity)
    when ``trace_dir`` is given, else nothing."""
    if trace_dir is None:
        return contextlib.nullcontext()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    return profile(activities=acts)


def run(n: int, l: int, device=DEFAULT, repeat: int = 3, trace_dir=None):
    """Set up, warm up and time the (n, l) leader-mode prove on ``device``.
    Returns (report, (pk, net, bundle)): the JSON line's fields, and the
    inputs, the party net and the last bundle.  ``init_s`` is the first
    allocation on the device (the CUDA context where the process has
    none yet), timed apart from ``setup_s``.  With ``trace_dir``, the
    timed proves run under ``torch.profiler`` and its trace is written to
    ``trace_dir/bench_trace.json`` (``report["trace"]``)."""
    dev = resolve(device)
    net = PartyNet(8 * l, mode="leader")
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk = packed_proving_parameters(n, l, net, device=dev)
    sync(dev)
    setup_s = time.perf_counter() - t0

    net.reset_comm()
    out = dhyperplonk(n, pk, net)  # warm-up: kernel loads, first launches
    sync(dev)
    comm = {"party0": list(net.comm(0)), "worker": list(net.comm(net.n - 1)),
            "rounds": net.rounds}
    runs = []
    with _trace(dev, trace_dir) as prof:
        for _ in range(max(repeat, 1)):
            t0 = time.perf_counter()
            out = dhyperplonk(n, pk, net)
            sync(dev)
            runs.append(time.perf_counter() - t0)
    trace = None
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        trace = os.path.join(trace_dir, TRACE_FILE)
        prof.export_chrome_trace(trace)

    timer.clear()
    timer.set_sync(lambda: sync(dev))  # a timed window: the recorder is on
    try:
        out = dhyperplonk(n, pk, net)
    finally:
        timer.set_sync(None)
    split = {label: dt for label, dt in timer.records() if label in SPANS}
    timer.clear()
    digest = proof_digest(pk.curve, out)
    tag = "cuda" if dev.type == "cuda" else "cpu"
    report = {
        "metric": f"dhyperplonk_per_party_prove_s_n{n}_l{l}_{tag}",
        "value": statistics.median(runs), "unit": "s", "runs": runs, "init_s": init_s,
        "setup_s": setup_s, "comm": comm, "split_s": split, "digest": f"0x{digest:016x}",
        "conformance": pin_verdict(n, l, digest),
        "device": _device_name(dev),
    }
    if trace is not None:
        report["trace"] = trace
    return report, (pk, net, out)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def conformance(device=DEFAULT) -> dict:
    """Prove every pinned (n, l) with n <= ``CONFORMANCE_PROVE_MAX_N`` in
    leader mode on ``device`` and hold its canonical digest against the
    pin: the JSON line of ``--conformance`` (``value`` 1 when all pass)."""
    dev = resolve(device)
    results = {}
    for (n, l), pin in PINS.items():
        if n > CONFORMANCE_PROVE_MAX_N:
            continue
        net = PartyNet(8 * l, mode="leader")
        pk = packed_proving_parameters(n, l, net, device=dev)
        d = proof_digest(pk.curve, dhyperplonk(n, pk, net))
        results[f"n{n}_l{l}"] = {"digest": f"0x{d:016x}", "pinned": f"0x{pin:016x}",
                                 "pass": d == pin}
    ok = all(r["pass"] for r in results.values())
    return {"metric": "conformance", "value": int(ok), "unit": "pass",
            "verdict": "PASS" if ok else "FAIL", "device": _device_name(dev),
            "results": results}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16, help="log2 gate count")
    ap.add_argument("--l", type=int, default=8, help="packing factor (N = 8l)")
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help=f"prove n = {SMOKE[0]}, l = {SMOKE[1]} on the requested device")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the timed proves into DIR")
    ap.add_argument("--conformance", action="store_true",
                    help="prove the pinned (6, 1) configuration on the requested device and "
                         "print one PASS/FAIL JSON line")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.l = SMOKE
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.conformance:
        report = conformance(args.device)
        print(json.dumps(report))
        return 0 if report["value"] else 1
    report, _ = run(args.n, args.l, args.device, args.repeat, args.trace)
    print(json.dumps(report))
    return 1 if report["conformance"].startswith("fail") else 0


if __name__ == "__main__":
    raise SystemExit(main())
