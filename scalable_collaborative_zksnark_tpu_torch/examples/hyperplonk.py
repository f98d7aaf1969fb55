"""Local and collaborative HyperPlonk on the port (the JAX package's
``examples/hyperplonk.py``, same CLI and seeds; parity:
hyperplonk/examples/hyperplonk.rs, bench_hyperplonk.rs,
bench_hyperplonk_dataparallel.rs).

    python -m scalable_collaborative_zksnark_tpu_torch.examples.hyperplonk --variant dist --n 16 --l 8

``--variant local|localpp`` proves on one device over a random SRS of
n + 2 variables; ``dist|dist-dp`` runs the collaborative prover (or its
data-parallel variant) and prints the per-party comm bytes.  ``--verify``
builds honest SRSs (on the device) and runs the verifier: on the local
bundle with ``--variant local``, on the complete ``dhyperplonk`` bundle
with ``--variant dist --mode sim``.
"""

from __future__ import annotations

import numpy as np

from ..curves import host_curve as hc
from ..curves.g1 import bls12_381_g1
from ..hyperplonk import (dhyperplonk, dhyperplonk_data_parallel, local_hyperplonk,
                          local_hyperplonkpp, local_inputs, packed_proving_parameters,
                          verify_local_hyperplonk)
from ..hyperplonk.collaborative import eq_top_table
from ..hyperplonk.params import consistent_proving_parameters
from ..hyperplonk.verify import verify_dhyperplonk
from ..mpc.net import PartyNet
from ..primitives.poly_comm import srs_from_secret, srs_random
from ..pss.pss import PackedSharingParams
from .common import base_parser, setup, timed


def _secrets(rng, count: int, p: int):
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(count)]


def _fails(fails) -> str:
    return "; " + "; ".join(fails) if fails else ""


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--variant", choices=("local", "localpp", "dist", "dist-dp"), default="dist")
    ap.add_argument("--verify", action="store_true",
                    help="build honest SRSs and verify the bundle (local, or dist with "
                         "--mode sim)")
    args = ap.parse_args(argv)
    dev = setup(args)
    curve = bls12_381_g1(dev)
    F = curve.fr
    n = args.n

    if args.variant in ("local", "localpp"):
        if args.verify:
            if args.variant != "local":
                raise SystemExit("--verify takes --variant local or dist")
            s = _secrets(np.random.RandomState(11), n + 2, F.p)
            srs = srs_from_secret(curve, hc.G1_GEN, hc.G2_GEN, s)
            ins = local_inputs(F, n)
            proof = local_hyperplonk(n, srs, ins)
            (ok, fails), dt = timed(lambda: verify_local_hyperplonk(n, srs, proof, ins), dev)
            print(f"verify local hyperplonk n={n}: ok={ok} ({dt:.3f} s){_fails(fails)}")
            return
        srs = srs_random(curve, n + 2, 7)
        fn = local_hyperplonk if args.variant == "local" else local_hyperplonkpp
        fn(n, srs)  # warm-up: kernel build and first launches
        _, dt = timed(lambda: fn(n, srs), dev)
        print(f"{args.variant} hyperplonk n={n}: {dt:.3f} s")
        return

    net = PartyNet(8 * args.l, mode=args.mode)
    if args.verify:
        if args.variant != "dist" or args.mode != "sim":
            raise SystemExit("--verify needs --variant dist --mode sim")
        pp = PackedSharingParams(F, args.l)
        rng = np.random.RandomState(13)
        d_srs = srs_from_secret(curve, hc.G1_GEN, hc.G2_GEN, _secrets(rng, n + 2, F.p),
                                n_parties=net.n)
        c_srs = srs_from_secret(curve, hc.G1_GEN, hc.G2_GEN, _secrets(rng, n + 2, F.p), pp=pp)
        pk, g = consistent_proving_parameters(n, args.l, net, {"c": c_srs, "d": d_srs},
                                              curve=curve)
        proof = dhyperplonk(n, pk, net)
        eq_top = eq_top_table(F, net.n)
        (ok, fails), dt = timed(lambda: verify_dhyperplonk(
            pp, c_srs, d_srs, proof, g, pk.challenge, pk.challenge_r2, eq_top), dev)
        print(f"verify dhyperplonk n={n} l={args.l}: ok={ok} ({dt:.3f} s){_fails(fails)}")
        return
    pk = packed_proving_parameters(n, args.l, net, curve=curve)
    fn = dhyperplonk if args.variant == "dist" else dhyperplonk_data_parallel
    fn(n, pk, net)  # warm-up
    net.reset_comm()
    _, dt = timed(lambda: fn(n, pk, net), dev)
    up, down = net.comm(0)
    print(f"{args.variant} hyperplonk n={n} l={args.l} mode={args.mode}: "
          f"{dt:.3f} s, comm up={up} down={down}")


if __name__ == "__main__":
    main()
