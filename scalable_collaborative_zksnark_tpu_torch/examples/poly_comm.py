"""Collaborative PCS commit and open on the port (the JAX package's
``examples/poly_comm.py``, same CLI and seeds; parity:
dist-primitive/examples/poly_comm.rs).

    python -m scalable_collaborative_zksnark_tpu_torch.examples.poly_comm --n 16 --l 8

``c_commit`` and ``c_open`` of a 2^n / l share table a party on
``srs_random``, each timed (after a warm-up on the card); the per-party
comm bytes are those of one commit and one open.
"""

from __future__ import annotations

from ..curves.g1 import bls12_381_g1
from ..mpc.net import PartyNet
from ..primitives.poly_comm import c_commit, c_open, srs_random
from ..pss.pss import PackedSharingParams
from .common import base_parser, setup, timed, warm_up


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    dev = setup(args)
    curve = bls12_381_g1(dev)
    F = curve.fr
    pp = PackedSharingParams(F, args.l)
    net = PartyNet(pp.n, mode=args.mode)
    P = net.local_parties
    m_loc = (1 << args.n) // pp.l

    srs = srs_random(curve, args.n, 7, packed_parties=pp.n, max_level=-1)
    peval = F.random((P, m_loc), 1)
    point = F.random((args.n + 2,), 2)

    commit = lambda: c_commit(srs, pp, net, [peval])  # noqa: E731
    warm_up(commit, dev)
    net.reset_comm()
    _, dt = timed(commit, dev)
    print(f"c_commit n={args.n} l={args.l}: {dt * 1e3:.1f} ms")

    open_ = lambda: c_open(srs, pp, net, peval, point)  # noqa: E731
    snap = net.comm_snapshot()
    warm_up(open_, dev)
    net.comm_restore(snap)
    _, dt = timed(open_, dev)
    up, down = net.comm(0)
    print(f"c_open   n={args.n} l={args.l}: {dt * 1e3:.1f} ms, comm up={up} down={down}")


if __name__ == "__main__":
    main()
