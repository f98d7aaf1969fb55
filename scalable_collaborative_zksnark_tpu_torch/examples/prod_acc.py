"""Product accumulation on the port (the JAX package's
``examples/prod_acc.py``, same CLI and seeds; parity:
dist-primitive/examples/prod_acc.rs).

    python -m scalable_collaborative_zksnark_tpu_torch.examples.prod_acc --n 16 --l 8

``c_acc_product_and_share`` on 2^n / l share evaluations a party, timed
(after a warm-up on the card), with the lengths of its three output streams and the
per-party comm bytes of one run.
"""

from __future__ import annotations

from ..fields.fr import get_field
from ..mpc.net import PartyNet
from ..primitives.acc_product import c_acc_product_and_share
from ..pss.pss import PackedSharingParams
from .common import base_parser, setup, timed, warm_up


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    dev = setup(args)
    F = get_field("bls12_381_fr", dev)
    pp = PackedSharingParams(F, args.l)
    net = PartyNet(pp.n, mode=args.mode)
    P = net.local_parties
    S = (1 << args.n) // pp.l

    shares = F.random((P, S), 1)
    masks = F.random((P, S), 2)
    unmask = F.random((P, 4 * S), 3)

    run = lambda: c_acc_product_and_share(pp, net, shares, masks, unmask, unmask, unmask)  # noqa: E731,E501
    warm_up(run, dev)
    net.reset_comm()
    out, dt = timed(run, dev)
    up, down = net.comm(0)
    print(f"c_acc_product_and_share n={args.n} l={args.l}: {dt * 1e3:.1f} ms, "
          f"streams {[o.shape[-2] for o in out]}, comm up={up} down={down}")


if __name__ == "__main__":
    main()
