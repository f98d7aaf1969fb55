"""Per-primitive host time of the flagship prove's pieces on the port.

The port of the JAX package's ``scripts/profile_primitives.py``: each
protocol primitive of the prove's dominant steps (the commit, the wire
identity's parts and the opens) runs on its own at the prove's shapes,
between two synchronisations of the device, once cold and then twice;
a row gives the best warm time and the cold one.  The inputs are the
bench entry's (``packed_proving_parameters``, leader mode).

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.profile_primitives [--n 16] [--l 8] [--only a,b] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

from ..device import DEFAULT, resolve, sync
from ..hyperplonk.collaborative import (_dsum_ch, _exchange_s, _num_den_h, _stackp,
                                        _zerocheck_layer)
from ..hyperplonk.params import packed_proving_parameters
from ..mpc.net import PartyNet
from ..primitives.acc_product import d_acc_product
from ..primitives.poly_comm import c_commit, c_open
from ..primitives.sumcheck import c_sumcheck_product, d_sumcheck_product

C = 8  # the prove's window-width hint


def steps(pk, net: PartyNet) -> dict:
    """The timed steps by name, each a function of no arguments."""
    F, pp = pk.pp.field, pk.pp
    n, P = pk.n, net.local_parties
    gc = 1 << n
    local_s_p = F.random((P, gc * 4 // net.n), 63)
    local_s = F.random((P, gc * 4 // net.n // pp.l), 64)
    s_shares = _exchange_s(F, net, local_s)
    num, den, h_p = _num_den_h(F, local_s_p, pk.sid_p, pk.eq_r1_p, pk.ssigma_p, pk.alpha,
                               pk.beta)
    grp8 = _stackp([pk.ssigma_p, pk.sid_p, h_p, num, den, h_p, num, den])
    grp5 = _stackp([pk.ssigma_p, pk.sid_p, h_p, num, den])
    grp3 = _stackp([pk.I_p, pk.S1_p, pk.S2_p])
    abc = _stackp([pk.a_evals, pk.b_evals, pk.c_evals])
    dc = pk.d_commitment
    out = {
        # the commit step
        "d_commit_grp3": lambda: dc.d_commit(net, grp3, c=C),
        "c_commit_abc": lambda: c_commit(pk.c_commitment, pp, net,
                                         [pk.a_evals, pk.b_evals, pk.c_evals], c=C),
        # the final opens
        "c_open_abc": lambda: c_open(pk.c_commitment, pp, net, abc, pk.challenge, c=C),
        "d_open_grp3": lambda: dc.d_open(net, grp3, pk.challenge, c=C),
        # the wire identity's part a
        "d_commit_s": lambda: dc.d_commit(net, local_s_p, c=C),
        "c_sumcheck_sV": lambda: c_sumcheck_product(pp, net, s_shares, pk.V, pk.challenge_r1),
        "c_open_V": lambda: c_open(pk.c_commitment, pp, net, pk.V, pk.challenge_r1, c=C),
        "d_open_s": lambda: dc.d_open(net, local_s_p, pk.challenge_r2, c=C),
        "num_den_h": lambda: _num_den_h(F, local_s_p, pk.sid_p, pk.eq_r1_p, pk.ssigma_p,
                                        pk.alpha, pk.beta),
        "d_acc_product": lambda: d_acc_product(F, net, h_p),
        "d_commit_grp8": lambda: dc.d_commit(net, grp8, c=C),
        "d_open_grp5": lambda: dc.d_open(net, grp5, pk.challenge_r2, c=C),
        "d_sumcheck3": lambda: d_sumcheck_product(
            F, net, _stackp([den, h_p, num]), _stackp([pk.eq_r2_p, den, pk.eq_r2_p]),
            _dsum_ch(net, pk.challenge_r2)),
    }
    # one layer of the layered zerocheck at three halving sizes
    M0 = gc * 4 // net.n // 2
    for sz in sorted({M0, M0 // 4, M0 // 16} - {0, 1}, reverse=True):
        v1, v0, vx, eqv = (F.random((P, sz), 70 + k + sz) for k in range(4))
        out[f"zc_layer_{sz}"] = (lambda v1=v1, v0=v0, vx=vx, eqv=eqv: _zerocheck_layer(
            pk, net, v1, v0, vx, eqv, pk.challenge_r2[1:], C))
    return out


def run(n: int = 16, l: int = 8, device=DEFAULT, only=()) -> list[dict]:
    """A row for each step (or each step named in ``only``): its best warm
    time of two and its cold time, in ms."""
    dev = resolve(device)
    net = PartyNet(8 * l, mode="leader")
    t0 = time.perf_counter()
    pk = packed_proving_parameters(n, l, net, device=dev)
    sync(dev)
    print(f"# setup: {time.perf_counter() - t0:.1f}s", flush=True)
    rows = []
    for name, fn in steps(pk, net).items():
        if only and name not in only:
            continue
        times = []
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            times.append(time.perf_counter() - t0)
        row = {"step": name, "warm_ms": min(times[1:]) * 1e3, "cold_ms": times[0] * 1e3}
        print(f"{name:18s} warm {row['warm_ms']:9.2f} ms   (cold {row['cold_ms']:9.2f} ms)",
              flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--only", default="", help="comma list of step names")
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.n, args.l, args.device, [s for s in args.only.split(",") if s])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
