"""Per-party prove time of the collaborative HyperPlonk prover on the port.

    python -m scalable_collaborative_zksnark_tpu_torch.bench --n 16 --l 8 [--device cuda] [--repeat 3]

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
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

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


def conformance(n: int, l: int, digest: int) -> str:
    pin = PINS.get((n, l))
    if pin is None:
        return f"no-pin (digest 0x{digest:016x})"
    return "pass" if digest == pin else f"fail (0x{digest:016x} != 0x{pin:016x})"


def run(n: int, l: int, device=DEFAULT, repeat: int = 3):
    """Set up, warm up and time the (n, l) leader-mode prove on ``device``.
    Returns (report, (pk, net, bundle)): the JSON line's fields, and the
    inputs, the party net and the last bundle.  ``init_s`` is the first
    allocation on the device (the CUDA context where the process has
    none yet), timed apart from ``setup_s``."""
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
    for _ in range(max(repeat, 1)):
        t0 = time.perf_counter()
        out = dhyperplonk(n, pk, net)
        sync(dev)
        runs.append(time.perf_counter() - t0)

    timer.clear()
    timer.set_sync(lambda: sync(dev))
    try:
        out = dhyperplonk(n, pk, net)
    finally:
        timer.set_sync(None)
    split = {label: dt for label, dt in timer.records() if label in SPANS}
    digest = proof_digest(pk.curve, out)
    tag = "cuda" if dev.type == "cuda" else "cpu"
    report = {
        "metric": f"dhyperplonk_per_party_prove_s_n{n}_l{l}_{tag}",
        "value": statistics.median(runs), "unit": "s", "runs": runs, "init_s": init_s,
        "setup_s": setup_s, "comm": comm, "split_s": split, "digest": f"0x{digest:016x}",
        "conformance": conformance(n, l, digest),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return report, (pk, net, out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16, help="log2 gate count")
    ap.add_argument("--l", type=int, default=8, help="packing factor (N = 8l)")
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    report, _ = run(args.n, args.l, args.device, args.repeat)
    print(json.dumps(report))
    return 1 if report["conformance"].startswith("fail") else 0


if __name__ == "__main__":
    raise SystemExit(main())
