"""Collaborative vs local sumcheck on the port (the JAX package's
``examples/sumcheck.py``, same CLI and seeds).

Runs ``c_sumcheck_product`` on PSS shares of a random 2^n-evaluation
table (per party 2^n / l evaluations) and the local ``sumcheck_product``
on 2^n evaluations, and reports per-party time and communication bytes:

    python -m scalable_collaborative_zksnark_tpu_torch.examples.sumcheck --n 26 --l 32
"""

from __future__ import annotations

import argparse

from ..device import DEFAULT
from ..fields.fr import get_field
from ..mpc.net import PartyNet
from ..primitives.sumcheck import c_sumcheck_product, sumcheck_product
from ..pss.pss import PackedSharingParams
from .common import timed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--l", type=int, default=2, help="packing factor (N = 8l)")
    ap.add_argument("--n", type=int, default=8, help="log2 problem size")
    ap.add_argument("--mode", choices=("sim", "leader"), default="leader")
    ap.add_argument("--device", default=DEFAULT, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    F = get_field("bls12_381_fr", device=args.device)
    pp = PackedSharingParams(F, args.l)
    net = PartyNet(pp.n, mode=args.mode)
    m_loc = (1 << args.n) // pp.l

    shares_f = F.random((net.local_parties, m_loc), 1)
    shares_g = F.random((net.local_parties, m_loc), 2)
    challenges = F.random((args.n + 4,), 3)
    step = lambda: c_sumcheck_product(pp, net, shares_f, shares_g, challenges)  # noqa: E731
    step()  # warm-up: kernel build and first launches
    net.reset_comm()
    proof, dt = timed(step, F.device)
    up, down = net.comm(0)
    print(f"c_sumcheck_product n={args.n} l={args.l} mode={args.mode}: "
          f"{dt*1e3:.1f} ms/step, proof {tuple(proof.shape)}, comm up={up} down={down}")

    evals_f = F.random((1 << args.n,), 4)
    evals_g = F.random((1 << args.n,), 5)
    local = lambda: sumcheck_product(F, evals_f, evals_g, challenges)  # noqa: E731
    local()
    _, dt = timed(local, F.device)
    print(f"local sumcheck_product n={args.n}: {dt*1e3:.1f} ms/step")


if __name__ == "__main__":
    main()
