"""The one job generator: a prover's tables for job k, made on the
device from the run's seed.

A traffic file gives the circuit size (``gates_log2``), the loop
(``closed``, one job in flight: a server proves one job at a time) and
which tables are fresh for every job (``fresh``: the witness shares a
delegator sends); every other table of the configuration (its circuit's
selectors and permutation slices, the public challenges) is drawn once per
run.  The configuration lists the tables and their lengths as
expressions in n, gc = 2^n, l and N.  Each table is uniform 16-bit limbs
with the top limb below r's, read as the Montgomery form of an element
(so uniform below r up to that cut); all tables of one draw come from one
``torch.randint`` on one generator seeded from (seed, stream).
"""

from __future__ import annotations

import torch

from .reference.field import BITS, LIMBS, R_MOD

STATIC, WARMUP, WINDOW = 0, 1, 2
"""Streams: the run's fixed tables, the warm-up job, window job k (WINDOW + k)."""
_TOP = R_MOD >> (BITS * (LIMBS - 1))


def stream_seed(seed: int, stream: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def prover_seed(seed: int, stream: int) -> int:
    """The seed handed to the prover for its own placeholder draws."""
    return stream_seed(seed, stream) % (1 << 26)


def table_shapes(cfg: dict, traffic: dict) -> dict:
    if traffic["loop"] != "closed" or traffic["in_flight"] != 1:
        raise ValueError("the generator serves closed loops with one job in flight only")
    n = traffic["gates_log2"]
    env = {"n": n, "gc": 1 << n, "l": cfg["l"], "N": cfg["N"]}
    out = {}
    for name, expr in cfg["tables"].items():
        dims = [int(eval(str(d), {"__builtins__": {}}, env)) for d in expr]  # noqa: S307
        out[name] = tuple(dims)
    return out


def draw(shapes: dict, seed: int, stream: int, device) -> dict:
    """Tables of ``shapes`` ({name: shape without the limb axis}), int32
    [..., 16] on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    sizes = {k: int(torch.Size(v).numel()) for k, v in shapes.items()}
    flat = torch.randint(0, 1 << BITS, (sum(sizes.values()), LIMBS), generator=gen,
                         device=device, dtype=torch.int32)
    flat[:, LIMBS - 1] %= _TOP
    out, off = {}, 0
    for k, shp in shapes.items():
        out[k] = flat[off:off + sizes[k]].reshape(tuple(shp) + (LIMBS,))
        off += sizes[k]
    return out


def static(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The run's fixed tables: every table the traffic does not renew."""
    shapes = table_shapes(cfg, traffic)
    return draw({k: v for k, v in shapes.items() if k not in traffic["fresh"]}, seed, STATIC,
                device)


def fresh(cfg: dict, traffic: dict, seed: int, stream: int, device) -> dict:
    """The tables of the job of ``stream`` that are its own."""
    shapes = table_shapes(cfg, traffic)
    return draw({k: v for k, v in shapes.items() if k in traffic["fresh"]}, seed, stream, device)
