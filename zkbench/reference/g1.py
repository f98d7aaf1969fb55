"""BLS12-381 G1 on the host, in Python integers: the group law, a
fixed-base table for multiples of the generator, and the check of a point
the program produced against an expected multiple of the generator."""

from __future__ import annotations

Q_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
"""The base field's modulus."""
B_COEFF = 4
GEN = (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
       0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)
"""The standard generator (draft-irtf-cfrg-pairing-friendly-curves)."""
FQ_MONT_RINV = pow(1 << 384, -1, Q_MOD)
"""The inverse of the radix of a base-field element held as 24 16-bit limbs."""

INF = (1, 1, 0)


def _double(P):
    X, Y, Z = P
    if Z == 0 or Y == 0:
        return INF
    p = Q_MOD
    A = X * X % p
    B = Y * Y % p
    C = B * B % p
    D = 2 * ((X + B) * (X + B) - A - C) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    return X3, (E * (D - X3) - 8 * C) % p, 2 * Y * Z % p


def _add_affine(P, a):
    """Jacobian P plus affine a."""
    X1, Y1, Z1 = P
    if Z1 == 0:
        return a[0], a[1], 1
    p = Q_MOD
    z1z1 = Z1 * Z1 % p
    u2 = a[0] * z1z1 % p
    s2 = a[1] * Z1 * z1z1 % p
    if u2 == X1:
        return _double(P) if s2 == Y1 else INF
    h = (u2 - X1) % p
    hh = h * h % p
    i = 4 * hh % p
    j = h * i % p
    r = 2 * (s2 - Y1) % p
    v = X1 * i % p
    X3 = (r * r - j - 2 * v) % p
    return X3, (r * (v - X3) - 2 * Y1 * j) % p, ((Z1 + h) * (Z1 + h) - z1z1 - hh) % p


def _affine(P):
    X, Y, Z = P
    if Z == 0:
        return None
    zi = pow(Z, -1, Q_MOD)
    zi2 = zi * zi % Q_MOD
    return X * zi2 % Q_MOD, Y * zi2 * zi % Q_MOD


class GeneratorTable:
    """k G by 32 additions from a table of d 2^(8w) G (w < 32, 0 < d < 256)."""

    def __init__(self):
        self.rows = []
        base = (GEN[0], GEN[1], 1)
        for _ in range(32):
            row, cur = [None], INF
            ab = _affine(base)
            for _ in range(255):
                cur = _add_affine(cur, ab)
                row.append(_affine(cur))
            self.rows.append(row)
            for _ in range(8):
                base = _double(base)

    def mul(self, k: int):
        """k G, Jacobian."""
        acc = INF
        for w, row in enumerate(self.rows):
            d = (k >> (8 * w)) & 0xFF
            if d:
                acc = _add_affine(acc, row[d])
        return acc


def on_curve(x: int, y: int) -> bool:
    return (y * y - x * x * x - B_COEFF) % Q_MOD == 0


def same_point(jac, expected) -> bool:
    """A Jacobian (X, Y, Z) equals a Jacobian expectation as a group element."""
    X1, Y1, Z1 = jac
    X2, Y2, Z2 = expected
    if Z1 == 0 or Z2 == 0:
        return Z1 == 0 and Z2 == 0
    p = Q_MOD
    z11, z22 = Z1 * Z1 % p, Z2 * Z2 % p
    return (X1 * z22 - X2 * z11) % p == 0 and (Y1 * z22 * Z2 - Y2 * z11 * Z1) % p == 0
