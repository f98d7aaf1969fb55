"""Sumcheck fold phases on the int8-matmul field engine (``fields/mxu.py``).

Mirrors the JAX package's ``primitives/mxu_sumcheck.py``: alternatives to
the fold-phase kernel (``cuda_sumcheck``) with the same canonical outputs.

* each round's three partial sums t0, t1, t2 contract the evaluation axis
  with int8 products (``dot_red``);
* both table folds lo + c * (hi - lo) are shared-scalar Montgomery
  products, one int8 product against the per-challenge matrix M_c;
* adds and subs stay in the redundant byte representation between rounds,
  so no element is made canonical inside the phase.

The output layout is that of ``sumcheck._rounds_product`` and
``_rounds_single``.  ``SCZK_MXU``, read at each call, selects this engine:
unset or ``0`` is off (the JAX package's default on every backend but the
TPU), any other value on.
"""

from __future__ import annotations

import os

import torch

from ..fields import mxu
from ..fields.mxu import Red, add_red, canon, dot_red, mul_shared, sub_red, sum_red


def available() -> bool:
    """The int8 phases, when ``SCZK_MXU`` is set to anything but 0."""
    flag = os.environ.get("SCZK_MXU")
    return flag is not None and flag != "0"


def _halves(r: Red):
    half = r.arr.shape[-2] // 2
    return Red(r.arr[..., :half, :], r.bound), Red(r.arr[..., half:, :], r.bound)


def product_phase(F, evals_f: torch.Tensor, evals_g: torch.Tensor, challenges: torch.Tensor,
                  start: int, count: int | None = None):
    """[..., M, L] tables -> (msgs: list of R [..., 3, L], cur_f, cur_g).

    Equal to ``sumcheck._rounds_product`` over the same challenges (R =
    ``count`` or log2 M rounds); the folded remainders [..., M/2^R, L] are
    canonical."""
    spec = F.spec
    M = evals_f.shape[-2]
    R = M.bit_length() - 1 if count is None else count
    cur_f = mxu.to_red(evals_f)
    cur_g = mxu.to_red(evals_g)
    raw = []  # per round (t0, t1, t2), redundant
    for r in range(R):
        lof, hif = _halves(cur_f)
        log_, hig = _halves(cur_g)
        t0 = dot_red(spec, lof, log_)
        t1 = dot_red(spec, hif, hig)
        df = sub_red(spec, hif, lof)
        dg = sub_red(spec, hig, log_)
        ef = add_red(hif, df)  # 2 * hi - lo
        eg = add_red(hig, dg)
        t2 = dot_red(spec, ef, eg)
        raw.append((t0, t1, t2))
        m_c, _ = mxu.fold_matrix(spec, F, challenges[start + r], df.bound, df.W)
        cur_f = add_red(lof, mul_shared(spec, df, m_c))
        cur_g = add_red(log_, mul_shared(spec, dg, m_c))
    msgs = _canon_rows(F, raw) if R else []
    return msgs, canon(spec, F, cur_f), canon(spec, F, cur_g)


def _canon_rows(F, raw):
    """Every round message made canonical by one ``canon`` call over the
    stacked (padded) redundant messages, then split per round."""
    k = len(raw[0])
    flat = [t for tup in raw for t in tup]
    W = max(t.W for t in flat)
    bound = max(t.bound for t in flat)
    arr = torch.stack([mxu._pad_w(t.arr, W) for t in flat], dim=0)
    limbs = canon(F.spec, F, Red(arr, bound))  # [R*k, ..., L]
    return [torch.stack([limbs[i * k + j] for j in range(k)], dim=-2) for i in range(len(raw))]


def single_phase(F, evals: torch.Tensor, challenges: torch.Tensor, start: int,
                 count: int | None = None):
    """[..., M, L] -> (msgs: list of R [..., 2, L], cur [..., M/2^R, L]);
    equal to ``sumcheck._rounds_single``."""
    spec = F.spec
    M = evals.shape[-2]
    R = M.bit_length() - 1 if count is None else count
    cur = mxu.to_red(evals)
    raw = []
    for r in range(R):
        lo, hi = _halves(cur)
        raw.append((sum_red(spec, lo), sum_red(spec, hi)))
        d = sub_red(spec, hi, lo)
        m_c, _ = mxu.fold_matrix(spec, F, challenges[start + r], d.bound, d.W)
        cur = add_red(lo, mul_shared(spec, d, m_c))
    msgs = _canon_rows(F, raw) if R else []
    return msgs, canon(spec, F, cur)
