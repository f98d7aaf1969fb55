"""End-to-end HyperPlonk proof verification.

Mirrors the JAX package's ``hyperplonk/verify.py``.  It verifies the
complete ``local_hyperplonk`` bundle and the collaborative ``dhyperplonk``
bundle (sim mode, every party's shares):

1. every sumcheck-product transcript is round-consistent and degree 2
   (the dsumcheck.rs:541-588 oracle semantics);
2. each transcript's final value is bound to the PCS-opened evaluations of
   its two polynomials at the transcript's challenge point;
3. every opening pairing-verifies against its commitment;
4. opened values of public polynomials (selectors, circuit input) equal
   the verifier's own MLE evaluation.

Not checked, as in the JAX package: the placeholder-input protocol never
commits the witness m, so the num/den relations cannot be re-derived by
the verifier; their transcripts and openings are checked as in 1-3.

The failure strings are the JAX package's, letter for letter.  The
unpacking of share points (``unpack_group``, the scalar ladder) and of
share transcripts (``unpack2``, the elementwise kernel) runs on the
proof's device, every point of a section in one ladder launch; the
transcript checks run on Python ints and the pairings on the host
(``curves/host_curve.py``), each pairing check in a ``Pairing check``
span of ``utils/timer.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..curves.g1 import PointJ, map_points
from ..fields.fr import Field
from ..primitives.mle import fix_variable
from ..primitives.poly_comm import PolynomialCommitment
from ..primitives.sumcheck import check_sumcheck_product
from ..utils.timer import trace as timed
from .local import LocalInputs


def eval_mle_ints(F: Field, evals: torch.Tensor, point: torch.Tensor) -> int:
    """Evaluate a multilinear table [2^k, L] at a point [k, L] -> int."""
    k = evals.shape[-2].bit_length() - 1
    v = fix_variable(F, evals, point[:k])
    return int(F.array_to_ints(v)[0])


def transcript_ints(F: Field, msgs: torch.Tensor) -> List[List[int]]:
    """[k, 3, L] sumcheck messages -> [[t0, t1, t2] ints]."""
    return [[int(x) for x in row] for row in F.array_to_ints(msgs)]


def _eval_deg2(p: int, row, x: int) -> int:
    """Evaluate the degree-2 round polynomial from its (t = 0, 1, 2) values."""
    inv2 = pow(2, -1, p)
    a = (row[2] - 2 * row[1] + row[0]) * inv2 % p
    b = (-row[2] + 4 * row[1] - 3 * row[0]) * inv2 % p
    return (a * x * x + b * x + row[0]) % p


def _check_product_transcript(F: Field, msgs, challenge_ints, expect_final: int, failures,
                              tag: str, has_final_row: bool = True) -> None:
    proof = transcript_ints(F, msgs)
    h = (proof[0][0] + proof[0][1]) % F.p
    if not check_sumcheck_product(F, h, proof, challenge_ints):
        failures.append(f"{tag}: transcript round-consistency")
    # local and c_ transcripts end with a (0, f(r) g(r), 0) row that the
    # consistency check already pins; d_ transcripts (as the reference's,
    # dsumcheck.rs:433) have none, so the last round polynomial is
    # evaluated at the last challenge instead
    if has_final_row:
        got = proof[-1][1] % F.p
    else:
        got = _eval_deg2(F.p, proof[-1], challenge_ints[len(proof) - 1])
    if got != expect_final % F.p:
        failures.append(f"{tag}: final value != product of opened evals")


def _value_int(F: Field, val: torch.Tensor) -> int:
    """An opened value [L] (or [1, L]) -> int."""
    return int(F.array_to_ints(val[None] if val.ndim == 1 else val).reshape(-1)[0])


def _pairing(srs: PolynomialCommitment, com, value: int, proofs, point_ints, g2_offset: int = 0):
    with timed("Pairing check"):
        return srs.verify(com, value, proofs, point_ints, g2_offset=g2_offset)


def _vrfy_open(srs, com, opn, point_ints, g2_offset, failures, tag, pairings):
    value = _value_int(srs.curve.fr, opn[0])
    if pairings and not _pairing(srs, com, value, opn[1], point_ints, g2_offset):
        failures.append(f"{tag}: pairing check")
    return value


def verify_local_hyperplonk(n: int, srs: PolynomialCommitment, proof, ins: LocalInputs,
                            pairings: bool = True) -> Tuple[bool, List[str]]:
    """Verify a ``local_hyperplonk`` bundle.

    ``ins`` supplies the verifier's data: the challenge points and the
    public polynomials (selectors, circuit input, the eq tables).  Returns
    (ok, failure descriptions).  ``pairings=False`` skips the pairing
    checks and keeps the algebraic binding checks."""
    F = srs.curve.fr
    (gate_proofs, gate_coms), (wire_proofs, wire_commits, wire_opens) = proof
    failures: List[str] = []
    p = F.p
    ch = [int(x) for x in F.array_to_ints(ins.challenge)]
    chp2 = [int(x) for x in F.array_to_ints(ins.challengep2)]

    # gate section: openings of a, b, c, input, q1, q2 at `challenge`
    vals = {}
    for name, (com, opn) in zip(("a", "b", "c", "input", "q1", "q2"), gate_coms):
        vals[name] = _vrfy_open(srs, com, opn, ch, 2, failures, f"open[{name}]", pairings)
    for name, tbl in (("input", ins.input), ("q1", ins.q1), ("q2", ins.q2)):
        if vals[name] != eval_mle_ints(F, tbl, ins.challenge):
            failures.append(f"open[{name}]: public value mismatch")
    eqv = eval_mle_ints(F, ins.eq, ins.challenge)
    gate_expect = [
        eqv * vals["q1"] % p,
        vals["q1"] * (vals["a"] + vals["b"]) % p,
        eqv * vals["q2"] % p,
        vals["a"] * vals["b"] % p,
        vals["q2"] * vals["a"] % p,
        eqv * ((vals["input"] - vals["c"]) % p) % p,
    ]
    for i, (msgs, exp) in enumerate(zip(gate_proofs, gate_expect)):
        _check_product_transcript(F, msgs, ch, exp, failures, f"gate[{i}]")

    # wire section: 8 polynomials at `challengep2`
    wvals = {}
    for name, com, opn in zip(("sid", "ssigma", "h", "num", "den", "vx0", "vx1", "v1x"),
                              wire_commits, wire_opens):
        wvals[name] = _vrfy_open(srs, com, opn, chp2, 0, failures, f"open[{name}]", pairings)
    for name, tbl in (("sid", ins.sid), ("ssigma", ins.ssigma)):
        if wvals[name] != eval_mle_ints(F, tbl, ins.challengep2):
            failures.append(f"open[{name}]: public value mismatch")
    eqp2v = eval_mle_ints(F, ins.eq_p2, ins.challengep2)
    wire_expect = [
        eqp2v * wvals["v1x"] % p,
        eqp2v * wvals["vx0"] % p,
        wvals["vx0"] * wvals["vx1"] % p,
        eqp2v * wvals["den"] % p,
        wvals["h"] * wvals["den"] % p,
        eqp2v * wvals["num"] % p,
    ]
    for i, (msgs, exp) in enumerate(zip(wire_proofs, wire_expect)):
        _check_product_transcript(F, msgs, chp2, exp, failures, f"wire[{i}]")
    return not failures, failures


# ---------------------------------------------------------------------------
# Collaborative proof assembly and verification
# ---------------------------------------------------------------------------
def _unpack_point(pp, curve, pt_shares: PointJ) -> PointJ:
    """Share points [N, ...] -> the secret points [...] (entry 0 of the l
    packed slots), all in one ``unpack_group``."""
    sec = pp.unpack_group(curve, map_points(lambda a: a.movedim(0, -2), pt_shares))
    return map_points(lambda a: a[..., 0, :], sec)


def _pick(pt: PointJ, *idx) -> PointJ:
    return map_points(lambda a: a[idx], pt)


def verify_dhyperplonk_gate(pp, c_srs_plain: PolynomialCommitment, d_srs: PolynomialCommitment,
                            proof, eq: torch.Tensor, challenge: torch.Tensor,
                            pairings: bool = True) -> Tuple[bool, List[str]]:
    """Assemble and verify the gate section of a ``dhyperplonk`` bundle.

    The verifier's view once the parties hand over their shares (sim mode:
    proof elements carry the party axis): each of the six gate transcripts
    unpacks across parties to the monolithic transcript; the c_opened
    witness values (a, b, c) and d_opened index and selector values (I,
    S1, S2) bind every transcript's final value; all six openings
    pairing-verify.  ``proof`` is the (gate_proofs, gate_coms) half of the
    bundle, proved from ``consistent_proving_parameters`` with honest SRSs;
    ``c_srs_plain`` the unpacked secret-derived SRS of the packed c-SRS;
    ``eq`` the public global eq table.  Transcripts are over ``challenge``
    (n variables under the (n + 2)-variable SRSs: g2 offset 2)."""
    F = c_srs_plain.curve.fr
    curve = c_srs_plain.curve
    gate_proofs, gate_coms = proof
    failures: List[str] = []
    p = F.p
    ch = [int(x) for x in F.array_to_ints(challenge)]

    # openings: a, b, c by c_open (their commitment and round proofs
    # unpacked in one ladder), I, S1, S2 by d_open
    shares = [map_points(lambda c_, q: torch.cat([c_[:, None], q], dim=1), com_sh, pis_sh)
              for com_sh, (_, pis_sh) in gate_coms[:3]]
    opened = _unpack_point(pp, curve, map_points(lambda *a: torch.stack(a, dim=1), *shares))
    vals = {}
    for j, (name, (_, (val_sh, _))) in enumerate(zip("abc", gate_coms[:3])):
        val = int(F.array_to_ints(pp.unpack(val_sh))[0])
        com = _pick(opened, j, 0)
        pis = [_pick(opened, j, 1 + i) for i in range(opened.x.shape[1] - 1)]
        if pairings and not _pairing(c_srs_plain, com, val, pis, ch, g2_offset=2):
            failures.append(f"c_open[{name}]: pairing check")
        vals[name] = val
    for name, (com_sh, (dval, dpis)) in zip(("I", "S1", "S2"), gate_coms[3:6]):
        val = _value_int(F, dval)
        if pairings and not _pairing(d_srs, _pick(com_sh, 0), val, dpis, ch, g2_offset=2):
            failures.append(f"d_open[{name}]: pairing check")
        vals[name] = val

    eqv = eval_mle_ints(F, eq, challenge)
    # the six transcripts, unpacked across parties in one unpack2
    expect = [
        eqv * vals["S1"] % p,
        vals["S1"] * (vals["a"] + vals["b"]) % p,
        eqv * vals["S2"] % p,
        vals["a"] * vals["b"] % p,
        vals["S2"] * vals["a"] % p,
        eqv * ((vals["I"] - vals["c"]) % p) % p,
    ]
    secrets = pp.unpack2(torch.stack(list(gate_proofs), dim=0).movedim(1, -2))  # [6, R, 3, l, L]
    msgs = F.sum(secrets, axis=-2)
    for i, exp in enumerate(expect):
        _check_product_transcript(F, msgs[i], ch, exp, failures, f"gate[{i}]")
    return not failures, failures


def verify_dhyperplonk_wire_a(pp, d_srs: PolynomialCommitment, wire, eq_r2: torch.Tensor,
                              challenge_r2: torch.Tensor,
                              pairings: bool = True) -> Tuple[bool, List[str]]:
    """Verify the wire identity's part a: the distributed openings of s and
    of the 5-polynomial group (ssigma, sid, h, num, den at r2)
    pairing-verify, and the three direct-zerocheck transcripts bind to the
    opened h/num/den values and the public eq(r2, x).  V's two openings
    (at r1 and r2) have no commitment in the protocol (dhyperplonk.rs:
    296-325, the reference's placeholder structure), so nothing pairs them.
    Parts b and c are ``verify_dhyperplonk_wire_layers`` and
    ``verify_dhyperplonk_wire_top``; ``verify_dhyperplonk_wire`` runs all
    three."""
    F = d_srs.curve.fr
    proofs, commits, opens = wire
    failures: List[str] = []
    p = F.p
    ch2 = [int(x) for x in F.array_to_ints(challenge_r2)]

    # d_open of s at r2 (opens[2]) against d_commit(s) (commits[0])
    sval, spis = opens[2]
    sv = _value_int(F, sval)
    if pairings and not _pairing(d_srs, _pick(commits[0], 0), sv, spis, ch2):
        failures.append("d_open[s]: pairing check")

    # the 8-group commit (commits[1..8]) and the 5-group open (opens[3..8])
    wvals = {}
    for i, name in enumerate(("ssigma", "sid", "h", "num", "den")):
        dval, dpis = opens[3 + i]
        val = _value_int(F, dval)
        if pairings and not _pairing(d_srs, _pick(commits[1 + i], 0), val, dpis, ch2):
            failures.append(f"d_open[{name}]: pairing check")
        wvals[name] = val

    eqv = eval_mle_ints(F, eq_r2, challenge_r2)
    # the direct zerocheck (den, eq_r2), (h, den), (num, eq_r2) consumes the
    # challenge in d_sumcheck order, local rounds ch[s:] first and leader
    # rounds ch[:s] last (_dsum_ch); its final value binds at ch2
    s = pp.n.bit_length() - 1
    chd = ch2[s:] + ch2[:s]
    expect = [wvals["den"] * eqv % p, wvals["h"] * wvals["den"] % p, wvals["num"] * eqv % p]
    for i, exp in enumerate(expect):
        _check_product_transcript(F, proofs[1 + i], chd, exp, failures, f"zerocheck[{i}]",
                                  has_final_row=False)
    return not failures, failures


def verify_dhyperplonk_wire_layers(pp, wire, eq_r2: torch.Tensor,
                                   challenge_r2: torch.Tensor) -> Tuple[bool, List[str]]:
    """Verify the layered zerocheck (wire part b, dhyperplonk.rs:415-478).

    Layer i (i = 1 .. n - log2 N) runs three d_sumcheck_products on the
    halving tree slices, (eq_i, v1x_i), (eq_i, vx0_i), (vx0_i, vx1_i), over
    challenge_r2[i:], and d_opens the three v-slices there.  The slices are
    witness-derived and uncommitted (the reference opens them without a
    commitment too), so the check is algebraic: each transcript is
    round-consistent in the _dsum_ch order and its final value equals the
    product of its two evaluations, the v-values from the layer's own
    d_opens and the eq value from the public eq_r2 table, by replaying the
    prover's slicing."""
    F = pp.field
    proofs, _commits, opens = wire
    failures: List[str] = []
    p = F.p
    N = pp.n
    s = N.bit_length() - 1
    layers = (len(proofs) - 7) // 3
    M = eq_r2.shape[-2] // N  # per-party block of the plain slices
    cur_eq = eq_r2.reshape(N, M, F.L)[:, : M // 2]
    for i in range(1, layers + 1):
        ch = challenge_r2[i:]
        ch_ints = [int(x) for x in F.array_to_ints(ch)]
        chd = ch_ints[s:] + ch_ints[:s]
        vals = [_value_int(F, opens[8 + 3 * (i - 1) + b][0]) for b in range(3)]  # v1x, vx0, vx1
        eqv = eval_mle_ints(F, cur_eq.reshape(-1, F.L), ch)
        expect = [eqv * vals[0] % p, eqv * vals[1] % p, vals[1] * vals[2] % p]
        for b, exp in enumerate(expect):
            _check_product_transcript(F, proofs[4 + 3 * (i - 1) + b], chd, exp, failures,
                                      f"layer[{i}][{b}]", has_final_row=False)
        cur_eq = cur_eq[:, cur_eq.shape[1] // 2:]
    return not failures, failures


def verify_dhyperplonk_wire_top(pp, d_srs: PolynomialCommitment, wire, eq_top: torch.Tensor,
                                challenge_r2: torch.Tensor,
                                pairings: bool = True) -> Tuple[bool, List[str]]:
    """Verify the leader's tree top (wire part c, rs:480-511).

    The leader commits the three N-element tree-top slices (vx0, vx1, v1x),
    opens them at challenge_r2[:log2 N] and runs three sumcheck_products
    against the public eq_top table.  The openings pairing-verify (an
    s-variable polynomial under the full SRS uses level s, the trailing
    variables' tensor, so g2_offset = n_srs - s), and each transcript's
    final value binds to eq_top(ch_top) times the opened slice value."""
    F = d_srs.curve.fr
    proofs, commits, opens = wire
    failures: List[str] = []
    p = F.p
    s = pp.n.bit_length() - 1
    ch_top = challenge_r2[:s]
    ch_ints = [int(x) for x in F.array_to_ints(ch_top)]
    nvars = len(d_srs.powers_of_g2) - 1
    vals = {}
    for b, name in enumerate(("vx0", "vx1", "v1x")):
        dval, dpis = opens[-3 + b]
        val = _value_int(F, dval)
        if pairings and not _pairing(d_srs, commits[-3 + b], val, dpis, ch_ints,
                                     g2_offset=nvars - s):
            failures.append(f"top open[{name}]: pairing check")
        vals[name] = val
    eqtv = eval_mle_ints(F, eq_top, ch_top)
    expect = [eqtv * vals["v1x"] % p, eqtv * vals["vx0"] % p, vals["vx0"] * vals["vx1"] % p]
    for b, exp in enumerate(expect):
        _check_product_transcript(F, proofs[-3 + b], ch_ints, exp, failures, f"top[{b}]")
    return not failures, failures


def verify_dhyperplonk(pp, c_srs_plain: PolynomialCommitment, d_srs: PolynomialCommitment, proof,
                       g: dict, challenge: torch.Tensor, challenge_r2: torch.Tensor,
                       eq_top: torch.Tensor, pairings: bool = True) -> Tuple[bool, List[str]]:
    """Verify a complete ``dhyperplonk`` bundle: the gate section (six
    transcripts, the a/b/c c_opens and I/S1/S2 d_opens of the final Open
    step) and the whole wire section (parts a, b, c).  ``g`` is the
    globals dict of ``consistent_proving_parameters`` (the verifier's
    public eq tables); ``eq_top`` the prover's seed-derived tree-top eq
    table."""
    gate, wire = proof
    _, fg = verify_dhyperplonk_gate(pp, c_srs_plain, d_srs, gate, g["eq"], challenge,
                                    pairings=pairings)
    _, fw = verify_dhyperplonk_wire(pp, d_srs, wire, g["eq_r2"], eq_top, challenge_r2,
                                    pairings=pairings)
    fails = fg + fw
    return not fails, fails


def verify_dhyperplonk_wire(pp, d_srs: PolynomialCommitment, wire, eq_r2: torch.Tensor,
                            eq_top: torch.Tensor, challenge_r2: torch.Tensor,
                            pairings: bool = True) -> Tuple[bool, List[str]]:
    """Verify the complete wire-identity section: part a (s and 5-group
    openings, the direct zerocheck), part b (the layered zerocheck) and
    part c (the leader's tree top)."""
    _, fa = verify_dhyperplonk_wire_a(pp, d_srs, wire, eq_r2, challenge_r2, pairings=pairings)
    _, fb = verify_dhyperplonk_wire_layers(pp, wire, eq_r2, challenge_r2)
    _, fc = verify_dhyperplonk_wire_top(pp, d_srs, wire, eq_top, challenge_r2, pairings=pairings)
    fails = fa + fb + fc
    return not fails, fails
