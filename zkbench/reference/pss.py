"""Packed secret sharing's linear maps, derived here from their definition.

n = 8l parties hold evaluations of one polynomial on the share domain
(the n-th roots of unity); its secrets sit on a coset g * <w_2l> of the
GENERATOR g (g * <w_4l> for products of shares).  ``pack`` interpolates
l secrets (padded to 2l with zeros) on the secret coset and evaluates on
the share domain; ``unpack`` interpolates n shares on the share domain,
keeps the first 2l coefficients (the radix-2 transforms' resize) and
evaluates on the secret coset; ``unpack2`` keeps 4l and reads every second
point of the 4l coset.  Every map is a small matrix of Python ints.
"""

from __future__ import annotations

import functools

from .field import GENERATOR, R_MOD, root_of_unity


def _interp(size: int, offset: int):
    """c[k][i]: coefficient k of the polynomial through values x_i at
    offset * w^i, as a matrix: offset^-k w^-ik / size."""
    w_inv = pow(root_of_unity(size), -1, R_MOD)
    o_inv = pow(offset, -1, R_MOD)
    s_inv = pow(size, -1, R_MOD)
    return [[pow(o_inv, k, R_MOD) * pow(w_inv, i * k, R_MOD) * s_inv % R_MOD
             for i in range(size)] for k in range(size)]


def _evaluate(points, coeffs):
    """out[a][i] = sum_k points[a]^k coeffs[k][i]."""
    rows = []
    for x in points:
        row = [0] * len(coeffs[0])
        xk = 1
        for ck in coeffs:
            for i, c in enumerate(ck):
                row[i] = (row[i] + xk * c) % R_MOD
            xk = xk * x % R_MOD
        rows.append(row)
    return rows


@functools.lru_cache(maxsize=None)
def maps(l: int) -> dict:
    """{"pack": [n][l], "unpack": [l][n], "unpack2": [l][n], "single": [n],
    "dmsm_w": [n], "dmsm_q": [n], "qw0": int} for packing factor l."""
    n = 8 * l
    g = GENERATOR
    w_n, w_2l, w_4l = root_of_unity(n), root_of_unity(2 * l), root_of_unity(4 * l)
    share_pts = [pow(w_n, j, R_MOD) for j in range(n)]
    by_share = _interp(n, 1)
    unpack = _evaluate([g * pow(w_2l, i, R_MOD) % R_MOD for i in range(l)], by_share[:2 * l])
    unpack2 = _evaluate([g * pow(w_4l, 2 * i, R_MOD) % R_MOD for i in range(l)], by_share[:4 * l])
    by_secret = [row[:l] for row in _interp(2 * l, g)]
    pack = _evaluate(share_pts, by_secret)
    single = [row[0] for row in pack]
    w = [sum(unpack2[i][j] for i in range(l)) % R_MOD for j in range(n)]
    q = [sum(pack[j][i] for i in range(l)) % R_MOD for j in range(n)]
    return {"pack": pack, "unpack": unpack, "unpack2": unpack2, "single": single,
            "dmsm_w": w, "dmsm_q": q, "qw0": q[0] * sum(w) % R_MOD}
