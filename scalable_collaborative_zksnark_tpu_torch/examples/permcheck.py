"""Collaborative and distributed permcheck on the port (the JAX package's
``examples/permcheck.py``, same CLI and seeds; parity:
hyperplonk/examples/permcheck.rs, bench_cpermcheck.rs, bench_dpermcheck.rs).

    python -m scalable_collaborative_zksnark_tpu_torch.examples.permcheck --variant d --n 16 --l 8

``--variant c`` is the baseline collaborative permcheck (paper section
4.3), ``d`` the improved distributed one (section 5.1); each prints its
time and the per-party comm bytes of one run.
"""

from __future__ import annotations

from ..hyperplonk import cpermcheck, dpermcheck, packed_proving_parameters
from ..mpc.net import PartyNet
from .common import base_parser, setup, timed


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--variant", choices=("c", "d"), default="d")
    args = ap.parse_args(argv)
    dev = setup(args)
    net = PartyNet(8 * args.l, mode=args.mode)
    pk = packed_proving_parameters(args.n, args.l, net, device=dev)
    fn = cpermcheck if args.variant == "c" else dpermcheck
    fn(args.n, pk, net)  # warm-up: kernel build and first launches
    net.reset_comm()
    _, dt = timed(lambda: fn(args.n, pk, net), dev)
    up, down = net.comm(0)
    print(f"{args.variant}permcheck n={args.n} l={args.l} mode={args.mode}: "
          f"{dt:.3f} s, comm up={up} down={down}")


if __name__ == "__main__":
    main()
