"""Share delegation to disk on the port (the JAX package's
``examples/delegator.py``, same CLI, seed and files; parity:
dist-primitive/examples/delegator.rs, the reference's one persistence
subsystem, delegator.rs:71-109).

    python -m scalable_collaborative_zksnark_tpu_torch.examples.delegator --n 16 --l 8 --out DIR

A delegator packs a seeded 2^n-entry witness into PSS shares and writes
one file per worker, ``worker_{i}.npy`` (its [2^n / l, 16] share table as
uint32 Montgomery limbs), and ``manifest.json``, in the JAX package's
format byte for byte, so either package reads what the other wrote.  The
workers' side then reads every file back and checks that the shares
reconstruct the witness.  ``--out`` defaults to ``sczk_shares`` in the
system's temporary directory.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..convert import from_numpy, to_numpy
from ..fields.fr import get_field
from ..primitives.mle import pack_vec, unpack_vec
from ..pss.pss import PackedSharingParams
from .common import base_parser, setup


def write_shares(out: Path, shares: torch.Tensor, F, l: int, n: int):
    """One ``worker_{i}.npy`` per party and the manifest, as the JAX package writes them."""
    out.mkdir(parents=True, exist_ok=True)
    for i in range(shares.shape[0]):
        np.save(out / f"worker_{i}.npy", to_numpy(shares[i]))
    (out / "manifest.json").write_text(
        json.dumps({"field": F.spec.name, "l": l, "n": n, "parties": shares.shape[0],
                    "form": "montgomery-u32-limbs"}))


def read_shares(out: Path, device) -> torch.Tensor:
    """The workers' share tables [N, 2^n / l, 16] back from ``out``."""
    manifest = json.loads((out / "manifest.json").read_text())
    return torch.stack([from_numpy(np.load(out / f"worker_{i}.npy"), device)
                        for i in range(manifest["parties"])])


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sczk_shares"),
                    help="output directory")
    args = ap.parse_args(argv)
    dev = setup(args)
    F = get_field("bls12_381_fr", dev)
    pp = PackedSharingParams(F, args.l)

    witness = F.random((1 << args.n,), 42)
    out = Path(args.out)
    write_shares(out, pack_vec(pp, witness), F, args.l, args.n)  # [N, m/l, L]
    print(f"wrote {pp.n} share files to {out}")

    ok = torch.equal(unpack_vec(pp, read_shares(out, dev)), witness)
    print(f"read-back reconstruction: {'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
