"""The monolithic HyperPlonk and HyperPlonk++ baseline provers.

Mirrors the JAX package's ``hyperplonk/local.py`` (parity:
hyperplonk.rs:15-316): seeded placeholder inputs, the six gate-identity
sumcheck products, the wire identity's grand product, 8 commit/open pairs
and 6 sumcheck products, and the final openings.  Like the reference it
is a cost-faithful simulation of the prover's arithmetic; the protocol
glue (virtual gate circuit, transcripts) is simplified identically
(hyperplonk.rs:70-72).

One device, tables [2^k, L]; the grand product h = num / den uses the
Montgomery batch inversion, as in the JAX package.  Same-size polynomials
committed or opened at one point share one MSM call, and same-size
sumcheck products one call (a batch axis), then are unstacked to the JAX
package's bundle, one entry a polynomial.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..curves.g1 import map_points
from ..fields.fr import Field
from ..primitives.acc_product import acc_product
from ..primitives.mle import fix_variable
from ..primitives.poly_comm import PolynomialCommitment
from ..primitives.sumcheck import sumcheck_product
from ..utils.timer import spanned
from ..utils.timer import trace as timed


@dataclasses.dataclass
class LocalInputs:
    """Placeholder prover inputs (hyperplonk.rs:18-47)."""

    n: int
    m: torch.Tensor          # witness, 2^(n+2)
    a: torch.Tensor          # fix_variable(m, [0, 0])
    b: torch.Tensor
    c: torch.Tensor
    input: torch.Tensor      # 2^n
    q1: torch.Tensor
    q2: torch.Tensor
    ssigma: torch.Tensor     # 2^(n+2)
    sid: torch.Tensor
    eq: torch.Tensor         # 2^n
    eq_p2: torch.Tensor      # 2^(n+2)
    challenge: torch.Tensor      # [n, L]
    challengep2: torch.Tensor    # [n+2, L]
    challengep2_2: torch.Tensor  # [n+2, L]
    alpha: torch.Tensor
    beta: torch.Tensor


def local_inputs(F: Field, n: int, seed: int = 0) -> LocalInputs:
    """The JAX package's seeded inputs (``seed * 7907 + k``), bit for bit."""
    gc = 1 << n
    zero, one = F.const(0), F.const(1)

    def r(shape, k):
        return F.random(shape, seed * 7907 + k)

    m = r((gc * 4,), 1)
    return LocalInputs(
        n=n, m=m,
        a=fix_variable(F, m, torch.stack([zero, zero])),
        b=fix_variable(F, m, torch.stack([zero, one])),
        c=fix_variable(F, m, torch.stack([one, zero])),
        input=r((gc,), 2), q1=r((gc,), 3), q2=r((gc,), 4),
        ssigma=r((gc * 4,), 5), sid=r((gc * 4,), 6),
        eq=r((gc,), 7), eq_p2=r((gc * 4,), 8),
        challenge=r((n,), 9), challengep2=r((n + 2,), 10), challengep2_2=r((n + 2,), 11),
        alpha=r((), 12), beta=r((), 13),
    )


def _wire_polys(F: Field, w: torch.Tensor, ins: LocalInputs, s_poly=None):
    """num / den / h of the wire identity (hyperplonk.rs:100-112, :255-268).

    Plain HyperPlonk: num = w + alpha sid + beta, den = w + alpha ssigma +
    beta.  HyperPlonk++ (``s_poly`` given): num uses s (M'), den uses eq in
    place of the witness (hyperplonk.rs:257-267)."""
    a_sid = F.mul(ins.alpha, ins.sid)
    a_ssig = F.mul(ins.alpha, ins.ssigma)
    if s_poly is None:
        num = F.add(F.add(w, a_sid), ins.beta)
        den = F.add(F.add(w, a_ssig), ins.beta)
    else:
        num = F.add(F.add(s_poly, a_sid), ins.beta)
        den = F.add(F.add(ins.eq_p2, a_ssig), ins.beta)
    return num, den, F.mul(num, F.batch_inv(den))


def _commits(srs: PolynomialCommitment, polys, c: int) -> List:
    """One commitment a polynomial, all of one size in one MSM call."""
    coms = srs.commit(torch.stack(polys), c=c)
    return [map_points(lambda a, b=b: a[b], coms) for b in range(len(polys))]


def _opens(srs: PolynomialCommitment, polys, point: torch.Tensor, c: int) -> List:
    """(value, proofs) a polynomial, all of one size opened at ``point`` in
    one fold and one ``msm_ragged``."""
    vals, pis = srs.open(torch.stack(polys), point, c=c)
    return [(vals[b], [map_points(lambda a, b=b: a[b], pi) for pi in pis])
            for b in range(len(polys))]


def _wire_section(F: Field, srs: PolynomialCommitment, ins: LocalInputs, num, den, h, c: int):
    """The wire identity's shared tail: grand product, 8 commit/open pairs,
    6 sumcheck products (hyperplonk.rs:113-141)."""
    with timed("Acc product"):
        vx0, vx1, v1x = acc_product(F, h)
    polys = (ins.sid, ins.ssigma, h, num, den, vx0, vx1, v1x)
    commits = _commits(srs, polys, c)
    opens = _opens(srs, polys, ins.challengep2, c)
    # zerocheck F(x) = eq(x) * (v1x - vx0 * vx1), then F(x) = eq(x) * (g * v0x - f)
    proofs = _sumchecks(F, [(ins.eq_p2, v1x), (ins.eq_p2, vx0), (vx0, vx1), (ins.eq_p2, den),
                            (h, den), (ins.eq_p2, num)], ins.challengep2)
    return proofs, commits, opens


def _sumchecks(F: Field, pairs, ch: torch.Tensor) -> List:
    """One sumcheck_product transcript a (f, g) pair, all of one size in one
    batched call."""
    fs, gs = zip(*pairs)
    return list(sumcheck_product(F, torch.stack(fs), torch.stack(gs), ch).unbind(0))


def _gate_section(F: Field, ins: LocalInputs):
    """The six gate-identity sumcheck products (hyperplonk.rs:67-92)."""
    return _sumchecks(F, [(ins.eq, ins.q1), (ins.q1, F.add(ins.a, ins.b)), (ins.eq, ins.q2),
                          (ins.a, ins.b), (ins.q2, ins.a),
                          (ins.eq, F.add(F.neg(ins.c), ins.input))], ins.challenge)


def _gate_polys(ins: LocalInputs):
    return (ins.a, ins.b, ins.c, ins.input, ins.q1, ins.q2)


def _gate_opens(srs: PolynomialCommitment, ins: LocalInputs, coms, c: int):
    return list(zip(coms, _opens(srs, _gate_polys(ins), ins.challenge, c)))


@spanned(job=True)
def local_hyperplonk(n: int, srs: PolynomialCommitment, ins: LocalInputs = None, seed: int = 0,
                     c: int = 8):
    """The monolithic baseline prover (hyperplonk.rs:15-160).

    Returns ``((gate_proofs, gate_coms), (wire_proofs, wire_commits,
    wire_opens))`` with the reference's element counts."""
    F = srs.curve.fr
    if ins is None:
        ins = local_inputs(F, n, seed)
    with timed("Local HyperPlonk"):
        with timed("Commit"):
            coms = _commits(srs, _gate_polys(ins), c)
        with timed("HyperPlonk Prover"):
            with timed("Gate identity"):
                gate_proofs = _gate_section(F, ins)
            with timed("Wire identity"):
                num, den, h = _wire_polys(F, ins.m, ins)
                wire = _wire_section(F, srs, ins, num, den, h, c)
            with timed("Open"):
                gate_coms = _gate_opens(srs, ins, coms, c)
    return (gate_proofs, gate_coms), wire


@spanned(job=True)
def local_hyperplonkpp(n: int, srs: PolynomialCommitment, ins: LocalInputs = None,
                       seed: int = 0, c: int = 8):
    """The HyperPlonk++ baseline (hyperplonk.rs:162-316): the witness
    permutation polynomial M'(s) adds a commit of s, the sumcheck M * s and
    three opens, and the wire polynomials use s and eq in place of the
    witness."""
    F = srs.curve.fr
    if ins is None:
        ins = local_inputs(F, n, seed)
    gc = 1 << n
    with timed("Local HyperPlonk++"):
        with timed("Commit"):
            coms = _commits(srs, _gate_polys(ins), c)
        with timed("HyperPlonk Prover"):
            with timed("Gate identity"):
                gate_proofs = _gate_section(F, ins)
            with timed("Wire identity"):
                s_poly = F.random((gc * 4,), seed * 7907 + 99)  # M' placeholder
                wire_commits = [srs.commit(s_poly, c=c)]
                wire_proofs = [sumcheck_product(F, ins.m, s_poly, ins.challengep2)]
                wire_opens = (_opens(srs, (s_poly, ins.m), ins.challengep2, c)
                              + [srs.open(ins.m, ins.challengep2_2, c=c)])
                num, den, h = _wire_polys(F, ins.m, ins, s_poly=s_poly)
                p2, c2, o2 = _wire_section(F, srs, ins, num, den, h, c)
                wire_proofs += p2
                wire_commits += c2
                wire_opens += o2
            with timed("Open"):
                gate_coms = _gate_opens(srs, ins, coms, c)
    return (gate_proofs, gate_coms), (wire_proofs, wire_commits, wire_opens)
