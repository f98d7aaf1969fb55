"""Distributed MSM on shares on the port (the JAX package's
``examples/msm.py``, same CLI and seeds; parity:
dist-primitive/examples/msm.rs).

    python -m scalable_collaborative_zksnark_tpu_torch.examples.msm --n 16 --l 8

``d_msm`` of 2^n / l share scalars a party over the generator, then the
local ``msm`` of 2^n / l points, each timed (after a warm-up on the
card); the per-party comm bytes are those of one ``d_msm``.
"""

from __future__ import annotations

from ..curves.g1 import BLS12_381_G1_GEN, bls12_381_g1, map_points
from ..mpc.net import PartyNet
from ..primitives.msm import d_msm, msm
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

    ks = F.decode(F.random((m_loc,), 3))
    g = curve.from_affine_ints([BLS12_381_G1_GEN])
    base = map_points(lambda a: a.expand(P, 1, m_loc, a.shape[-1]), g)
    scal = F.decode(F.random((P, 1, m_loc), 4))

    run = lambda: d_msm(curve, pp, net, base, scal)  # noqa: E731
    warm_up(run, dev)
    net.reset_comm()
    _, dt = timed(run, dev)
    up, down = net.comm(0)
    print(f"d_msm n={args.n} l={args.l} ({m_loc} pts/party): {dt * 1e3:.1f} ms, "
          f"comm up={up} down={down}")

    base1 = map_points(lambda a: a[0, 0], base)
    local = lambda: msm(curve, base1, ks)  # noqa: E731
    warm_up(local, dev)
    _, dt = timed(local, dev)
    print(f"local msm ({m_loc} pts): {dt * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
