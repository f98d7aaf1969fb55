"""Warm time of each step of the flagship prove on the port.

The port of the JAX package's ``scripts/profile_phases.py``: each step of
``dhyperplonk`` (leader mode, the bench entry's inputs) runs on its own,
in the prove's order and on the previous step's outputs, between two
synchronisations of the device: once cold, then ``--reps`` times; a row
gives the best warm time and the cold one.  The steps are the port's own
functions (the JAX package's phased executables are a TPU compile
workaround the port does not have): the commit, the gate identity, the
wire identity's part a, the layered zerocheck's merged sumchecks and its
merged opens, part c, and the final opens.  ``--only-prims`` times the
primitives instead, through ``scripts/profile_primitives.py``.

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.profile_phases [--n 16] [--l 8] [--reps 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

from ..device import DEFAULT, resolve, sync
from ..hyperplonk import collaborative as co
from ..hyperplonk.params import packed_proving_parameters
from ..mpc.net import PartyNet
from . import profile_primitives

C = 8  # the prove's window-width hint


def _wire_b_opens(n: int, pk, net: PartyNet, v1x, vx0, vx1):
    """The layered zerocheck's opens, as ``_wire_part_b`` makes them: one
    ``d_open_many`` over the halving slices of every layer."""
    s_bits = net.n.bit_length() - 1
    half = v1x.shape[-2] // 2
    cur = [v1x[..., :half, :], vx0[..., :half, :], vx1[..., :half, :]]
    items = []
    for i in range(1, n - s_bits + 1):
        items.append((co._stackp(cur), pk.challenge_r2[i:]))
        cur = [t[..., t.shape[-2] // 2:, :] for t in cur]
    return pk.d_commitment.d_open_many(net, items, c=C)


def run(n: int = 16, l: int = 8, device=DEFAULT, reps: int = 5) -> list[dict]:
    """A row for each step of the prove: its best warm time of ``reps`` and
    its cold time, in ms."""
    dev = resolve(device)
    net = PartyNet(8 * l, mode="leader")
    t0 = time.perf_counter()
    pk = packed_proving_parameters(n, l, net, device=dev)
    sync(dev)
    print(f"# setup: {time.perf_counter() - t0:.1f}s", flush=True)
    F = pk.pp.field
    gc = 1 << n
    # dhyperplonk's placeholders at its default seed
    local_s_p = net.random_rows(F, (gc * 4 // net.n,), 2 * 31 + 1)
    local_s = net.random_rows(F, (gc * 4 // net.n // pk.pp.l,), 2 * 31 + 2)
    eq_top = co.eq_top_table(F, net.n)
    rows = []

    def timed(name, fn, *args):
        times = []
        for _ in range(reps + 1):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            sync(dev)
            times.append(time.perf_counter() - t0)
        row = {"step": name, "warm_ms": min(times[1:]) * 1e3, "cold_ms": times[0] * 1e3}
        print(f"{name:28s} warm {row['warm_ms']:9.2f} ms   (cold {row['cold_ms']:9.2f} ms)",
              flush=True)
        rows.append(row)
        return out

    coms = timed("commit", co._commit_step, pk, net, C)
    timed("gate_identity", co._gate_identity, pk, net)
    s_shares = timed("exchange_s", co._exchange_s, F, net, local_s)
    wa = timed("wire_a", co._wire_part_a, n, pk, net, local_s_p, s_shares, C)
    v1x, vx0, vx1, leader_tree = wa[3]
    timed("wire_b_sums (merged)", co._wire_b_sumchecks, pk, net, v1x, vx0, vx1, pk.eq_r2_p,
          pk.challenge_r2)
    timed("wire_b_opens (merged)", _wire_b_opens, n, pk, net, v1x, vx0, vx1)
    timed("wire_c", co._wire_part_c, pk, net, leader_tree, eq_top, C)
    timed("final_opens", co._final_opens, pk, net, coms, C)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--only-prims", action="store_true",
                    help="time the primitives (scripts/profile_primitives.py) instead")
    args = ap.parse_args(argv)
    if args.only_prims:
        profile_primitives.run(args.n, args.l, args.device)
    else:
        run(args.n, args.l, args.device, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
