"""Host-side (Python-int) BLS12-381 curve + pairing oracle.

The port's own copy of the JAX package's ``curves/host_curve.py`` (which
imports no JAX; the port imports nothing of that package).  Exact
arbitrary-precision arithmetic for G1/G2 group ops and the full BLS12-381
pairing: ``srs_random`` builds its G2 powers with it and
``PolynomialCommitment.verify`` pairs with it.  The prover's hot path
runs on the card (curves/g1.py, primitives/); pairings only appear in
PCS verification (a handful per proof -- cf. dpoly_comm.rs:466-484), so
a host implementation is the right tool.

The pairing is the ate pairing: Miller loop f_{|x|,Q}(P) with the BLS
parameter x = -0xd201000000010000, followed by the full final
exponentiation to (q^12 - 1)/r = (q^6 - 1)(q^2 + 1)(q^4 - q^2 + 1)/r: the
first two factors by conjugation, one inversion and the q^2-Frobenius, the
last by Python pow -- the same value as one pow to (q^12 - 1)/r, with a
third of its products.
"""

from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = 0xD201000000010000  # |x|; x itself is negative

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


# ---------------------------------------------------------------------------
# Fq2 / Fq6 / Fq12 tower (tuples of ints; Fq2 = Fq[u]/(u^2+1),
# Fq6 = Fq2[v]/(v^3 - (u+1)), Fq12 = Fq6[w]/(w^2 - v))
# ---------------------------------------------------------------------------
def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    n = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(n, -1, P)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # v^3 = u + 1


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def _mul_xi(a):
    return f2_mul(a, XI)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), _mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a2, c1), f2_mul(a1, c2))
    t = f2_add(_mul_xi(t), f2_mul(a0, c0))
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


F6_ZERO = (F2_ZERO,) * 3
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    # v-shift of an Fq6 element: (c0,c1,c2)*v = (xi*c2, c0, c1)
    t1v = (_mul_xi(t1[2]), t1[0], t1[1])
    c0 = f6_add(t0, t1v)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_inv(a):
    a0, a1 = a
    t = f6_mul(a1, a1)
    tv = (_mul_xi(t[2]), t[0], t[1])
    norm = f6_sub(f6_mul(a0, a0), tv)
    ninv = f6_inv(norm)
    return (f6_mul(a0, ninv), f6_neg(f6_mul(a1, ninv)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


F12_ONE = (F6_ONE, F6_ZERO)


def _f2_pow(a, e):
    result, base = F2_ONE, a
    while e:
        if e & 1:
            result = f2_mul(result, base)
        base = f2_sqr(base)
        e >>= 1
    return result


# (w^k)^(q^2) = w^k * xi^(k (q^2 - 1) / 6) for the Fq2 coefficient of w^k,
# with w^6 = xi; the q^2-power map is the identity on Fq2
_FROB2 = [_f2_pow(XI, k * (P * P - 1) // 6) for k in range(6)]


def f12_frob2(a):
    """a^(q^2): the coefficient of w^k (c0 holds w^0, w^2, w^4, c1 holds
    w^1, w^3, w^5) times xi^(k (q^2 - 1) / 6)."""
    c0, c1 = a
    return (tuple(f2_mul(c0[i], _FROB2[2 * i]) for i in range(3)),
            tuple(f2_mul(c1[i], _FROB2[2 * i + 1]) for i in range(3)))


def final_exponentiation(f):
    """f^((q^12 - 1) / r): f^(q^6 - 1) = conj(f) / f, then ^(q^2 + 1) by the
    q^2-Frobenius, then the hard part (q^4 - q^2 + 1) / r by pow."""
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frob2(f), f)
    return f12_pow(f, (P**4 - P**2 + 1) // R)


def f12_pow(a, e):
    result = F12_ONE
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sqr(base)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Curve ops (affine, generic over base field ops)
# ---------------------------------------------------------------------------
def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_neg(p1):
    return None if p1 is None else (p1[0], (-p1[1]) % P)


def g1_mul(p1, k):
    k %= R
    acc = None
    add = p1
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_neg(p1):
    return None if p1 is None else (p1[0], f2_neg(p1[1]))


def g2_mul(p1, k):
    k %= R
    acc = None
    add = p1
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


def g2_linear_map(mat, pts):
    """out_j = sum_i mat[j, i] * pts[i] over host-int G2 affine points.

    The PSS pack/unpack/unpack2 matrices applied to G2 elements — the
    host-exact realization of the reference's DomainCoeff genericity
    (secret-sharing/src/pss.rs:69: the share FFT is generic over any
    scalar-module, G2 included).  G2 appears only on the verify/SRS
    side (dpoly_comm.rs powers_of_g2), so a host path is the whole
    requirement; pts: list of (x, y) Fq2 pairs or None.
    """
    import numpy as np

    mat = np.asarray(mat, dtype=object)
    out = []
    for j in range(mat.shape[0]):
        acc = None
        for i, pt in enumerate(pts):
            k = int(mat[j, i]) % R
            if k and pt is not None:
                acc = g2_add(acc, g2_mul(pt, k))
        out.append(acc)
    return out


def g1_is_on_curve(p1):
    if p1 is None:
        return True
    x, y = p1
    return (y * y - x * x * x - 4) % P == 0


def g2_is_on_curve(p2):
    if p2 is None:
        return True
    x, y = p2
    b = f2_scalar(XI, 4)  # b' = 4(1+u)
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), b)) == F2_ZERO


# ---------------------------------------------------------------------------
# Pairing
# ---------------------------------------------------------------------------
def pairing(p1, p2):
    """ate pairing e(P, Q) for P in G1 (affine ints), Q in G2 (affine Fq2).

    Returns an Fq12 element.  e(inf, Q) = e(P, inf) = 1.
    """
    if p1 is None or p2 is None:
        return F12_ONE
    return final_exponentiation(_miller_loop(p1, p2))


def _untwist_line_eval(lam, c, px, py):
    """Fq12 value of the tangent/chord line at the untwisted point P.

    Derivation: with Fq12 = Fq6[w]/(w^2 - v), Fq6 = Fq2[v]/(v^3 - xi),
    xi = 1+u, the untwist of a twist point (x', y') is (x'/w^2, y'/w^3)
    (w^6 = xi makes the curve constant come out to b = 4).  For the line
    y = lam*x + c in twist coordinates, its value at P = (px, py) after
    untwisting is
        l(P) = py - lam*px*w^{-1} - c*w^{-3}
    Multiplying by xi (an Fq2 constant — killed by the final
    exponentiation since c^(q^6-1) = 1 for c in Fq2) and using
    w^{-1} = w^5/xi, w^{-3} = w^3/xi:
        l ~ xi*py  - c*w^3  - lam*px*w^5
    i.e. Fq6 coefficients a = (xi*py, 0, 0), b = (0, -c, -lam*px).
    """
    a = (f2_scalar(XI, py), F2_ZERO, F2_ZERO)
    b = (F2_ZERO, f2_neg(c), f2_neg(f2_scalar(lam, px)))
    return (a, b)


def _miller_loop(p1, p2):
    px, py = p1
    t = p2
    f = F12_ONE
    for bit in bin(BLS_X)[3:]:
        # doubling step
        x, y = t
        lam = f2_mul(f2_scalar(f2_sqr(x), 3), f2_inv(f2_scalar(y, 2)))
        c = f2_sub(y, f2_mul(lam, x))
        t = (
            f2_sub(f2_sqr(lam), f2_scalar(x, 2)),
            f2_sub(f2_mul(lam, f2_sub(x, f2_sub(f2_sqr(lam), f2_scalar(x, 2)))), y),
        )
        line = _untwist_line_eval(lam, c, px, py)
        f = f12_mul(f12_sqr(f), line)
        if bit == "1":
            # addition step T + Q
            x1, y1 = t
            x2, y2 = p2
            if x1 == x2 and f2_add(y1, y2) == F2_ZERO:
                t = None  # cannot happen inside the BLS loop
            else:
                if x1 == x2:
                    lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
                else:
                    lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
                c = f2_sub(y1, f2_mul(lam, x1))
                x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
                t = (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))
                line = _untwist_line_eval(lam, c, px, py)
                f = f12_mul(f, line)
    # BLS parameter x is negative: conjugate (f -> f^{-1} up to final exp)
    return f12_conj(f)


def pairing_product(pairs) -> tuple:
    """prod e(P_i, Q_i) — shares one final exponentiation."""
    f = F12_ONE
    todo = [(p, q) for p, q in pairs if p is not None and q is not None]
    for p1, p2 in todo:
        f = f12_mul(f, _miller_loop(p1, p2))
    return final_exponentiation(f)


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 -- the verifier's actual predicate (the
    pure-Python tower; the JAX package may route it to a native oracle)."""
    return pairing_product(pairs) == F12_ONE
