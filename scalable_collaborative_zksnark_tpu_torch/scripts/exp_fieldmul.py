"""Experiment: Fr Montgomery-product formulations and layouts on the card.

The port of the JAX package's ``scripts/exp_fieldmul.py``.  At 2^m
elements (``F.random`` seeds 1 and 2, the JAX package's bits):

  A. ``Field.mul``: the element-major kernel of ``csrc/fr.cu`` ([M, 16]);
  B. the script's unrolled 16-bit CIOS as PyTorch ops, one limb row at a
     time (``cuda_fr.mul_cios16_plain``): the plain version of C and D;
  C. the limb-major kernel on [16, M] (``cuda_fr.mul_limb_major``);
  D. the tiled kernel on [M / 4096, 16, 8, 512] (``cuda_fr.mul_tiled``).

Each must equal A bit for bit.  For C and D, ``ms`` times the formulation
as the JAX script does, the transposes into and out of the layout
included; ``kernel_ms`` the kernel alone on its layout.  Times are the
best of ``reps`` runs after a warm-up (CUDA events on the card, the host
clock on the CPU):

    python -m scalable_collaborative_zksnark_tpu_torch.scripts.exp_fieldmul --m 20 [--device cuda]
"""

from __future__ import annotations

import time

import torch

from ..device import DEFAULT, resolve
from ..examples.common import base_parser, setup
from ..fields import cuda_fr
from ..fields.fr import get_field
from ..utils.digest import limb_digest

def _best_ms(fn, device: torch.device, reps: int) -> tuple[float, torch.Tensor]:
    """(best milliseconds of ``reps`` runs after one warm-up, last output)."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def to_limb_major(x: torch.Tensor) -> torch.Tensor:
    """[M, L] -> [L, M]."""
    return x.T.contiguous()


def from_limb_major(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()


def to_tiled(x: torch.Tensor) -> torch.Tensor:
    """[M, L] -> [M / 4096, L, 8, 512]: element s * 512 + l of tile g at
    [g, :, s, l] (the JAX script's reshape and transpose)."""
    M, L = x.shape
    return x.reshape(M // cuda_fr.TILE, *cuda_fr.TILE_SHAPE, L).permute(0, 3, 1, 2).contiguous()


def from_tiled(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def run(m: int = 20, device=DEFAULT, reps: int = 5) -> list[dict]:
    """Time and check the four formulations at 2^m elements (m >= 12); print
    one line each and return the rows (name, what it is, ms, Mmul/s,
    ``kernel_ms`` for C and D, ``match`` against A, A's ``digest``)."""
    if m < 12:
        raise ValueError(f"the tiled layout needs 2^m >= {cuda_fr.TILE} elements, got m = {m}")
    dev = resolve(device)
    F = get_field("bls12_381_fr", dev)
    spec, M = F.spec, 1 << m
    a, b = F.random((M,), 1), F.random((M,), 2)
    at, bt = to_limb_major(a), to_limb_major(b)
    a4, b4 = to_tiled(a), to_tiled(b)
    forms = [
        ("A", "fr.cu element-major", lambda: F.mul(a, b), None),
        ("B", "unrolled 16-bit CIOS", lambda: cuda_fr.mul_cios16_plain(spec, a, b), None),
        ("C", "limb-major [16, M]",
         lambda: from_limb_major(cuda_fr.mul_limb_major(spec, to_limb_major(a), to_limb_major(b))),
         lambda: cuda_fr.mul_limb_major(spec, at, bt)),
        ("D", "tiled [G, 16, 8, 512]",
         lambda: from_tiled(cuda_fr.mul_tiled(spec, to_tiled(a), to_tiled(b))),
         lambda: cuda_fr.mul_tiled(spec, a4, b4)),
    ]
    rows, ref = [], None
    for name, what, fn, kernel in forms:
        ms, out = _best_ms(fn, dev, reps)
        row = {"name": name, "formulation": what, "ms": ms, "mmul_per_s": M / ms / 1e3}
        if kernel is not None:
            row["kernel_ms"] = _best_ms(kernel, dev, reps)[0]
        if ref is None:
            ref = out
            row["digest"] = limb_digest(out)
        row["match"] = bool(torch.equal(out, ref))
        rows.append(row)
        extra = f"  (kernel alone {row['kernel_ms']:.3f} ms)" if kernel is not None else ""
        print(f"{name} {what:22s} [2^{m}]: {ms:8.3f} ms ({row['mmul_per_s']:8.1f} Mmul/s) "
              f"{'match' if row['match'] else 'MISMATCH'}{extra}", flush=True)
    return rows


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--m", type=int, default=20, help="log2 elements")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = setup(args)
    rows = run(args.m, dev, args.reps)
    return 0 if all(r["match"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
