"""Discrete logarithms of the benchmark SRS's points.

The benchmark proves against the random SRS that a deployment's
benchmark builds from a fixed seed (the reference's ``new_single`` /
``new_random``): every point is A_c + B_r, where A_c = a_c G and B_r =
b_r G for small scalars a and b drawn from ``numpy.random.RandomState``,
laid out row by row over a grid of ceil(sqrt(count)) (at most 4,096)
columns; levels are consecutive slices of one such grid.  So every point
is a known multiple of G, and an MSM over these points is the multiple of
G by the scalar dot product with these logarithms.  This module draws
the same small scalars from the same seeds and returns the logarithms as
field tensors; it never touches a point.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import BITS, LIMBS, MASK, Fr


def flat_logs(count: int, seed: int) -> np.ndarray:
    """The logarithms (int64) of one grid of ``count`` points."""
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    side = min(max(int(np.ceil(np.sqrt(count))), 1), 4096)
    rows = (count + side - 1) // side
    ka = rng.randint(1, 1 << 16, size=(side, 2)).astype(np.int64)
    kb = rng.randint(1, 1 << 16, size=(rows, 2)).astype(np.int64)
    a = ka[:, 0] + (ka[:, 1] << 16)
    b = kb[:, 0] + (kb[:, 1] << 16)
    return (b[:, None] + a[None, :]).reshape(-1)[:count]


def level_logs(F: Fr, sizes, seed: int) -> list[torch.Tensor]:
    """The levels of ``sizes`` points drawn as one grid, as Montgomery tensors."""
    flat = flat_logs(int(sum(sizes)), seed)
    raw = np.stack([(flat >> (BITS * i)) & MASK for i in range(LIMBS)], axis=-1)
    logs = F.from_raw(torch.from_numpy(raw).to(F.device))
    offs = np.cumsum([0] + list(sizes))
    return [logs[int(o):int(o) + int(s)] for o, s in zip(offs, sizes)]


def benchmark_srs_logs(F: Fr, n: int, l: int, seed: int) -> dict:
    """The logarithms of the prove's SRS pair for 2^n gates and N = 8l
    parties, built from ``seed``: "packed" (the collaborative side's
    share points, max(2^k / l, 1) at level k <= n + 2, drawn from seed +
    17 + 211), "powers" (the distributed side's levels 2^k up to
    max(n + 2 - log2 N, log2 N), from seed + 23) and "roots" (its root
    levels 2^j, j < log2 N, from seed + 23 + 101)."""
    N = 8 * l
    s = N.bit_length() - 1
    top = min(max(n + 2 - s, s), n + 2)
    return {"packed": level_logs(F, [max((1 << k) // l, 1) for k in range(n + 3)], seed + 17 + 211),
            "powers": level_logs(F, [1 << k for k in range(top + 1)], seed + 23),
            "roots": level_logs(F, [1 << j for j in range(s)], seed + 23 + 101)}
