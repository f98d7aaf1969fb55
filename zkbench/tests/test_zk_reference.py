"""The plain reference's pieces on their own: field arithmetic against
Python integers, the sharing maps against their definition, the host
group law, and the SRS's logarithms against the points the program
builds."""

import random

import pytest
import torch

from zkbench.reference import g1, pss, srs
from zkbench.reference.field import R_MOD, Fr, root_of_unity

F = Fr("cpu")


def test_field_ops_match_python_ints():
    rng = random.Random(5)
    xs = [rng.randrange(R_MOD) for _ in range(64)] + [0, 1, R_MOD - 1]
    ys = [rng.randrange(R_MOD) for _ in range(64)] + [R_MOD - 1, 0, R_MOD - 1]
    a, b = F.from_ints(xs), F.from_ints(ys)
    assert list(F.to_ints(F.mul(a, b))) == [x * y % R_MOD for x, y in zip(xs, ys)]
    assert list(F.to_ints(F.add(a, b))) == [(x + y) % R_MOD for x, y in zip(xs, ys)]
    assert list(F.to_ints(F.sub(a, b))) == [(x - y) % R_MOD for x, y in zip(xs, ys)]
    assert list(F.to_ints(F.neg(a))) == [-x % R_MOD for x in xs]
    assert int(F.to_ints(F.sum(a, axis=0))) == sum(xs) % R_MOD
    inv = F.to_ints(F.batch_inv(a[None]))[0]
    assert all(i * x % R_MOD == (1 if x else 0) for i, x in zip(inv, xs))
    assert int(F.to_ints(F.pow(F.const(3), 1000))) == pow(3, 1000, R_MOD)
    raw = torch.tensor([[7] + [0] * 15])
    assert list(F.to_ints(F.from_raw(raw))) == [7]


def test_roots_of_unity():
    w = root_of_unity(64)
    assert pow(w, 64, R_MOD) == 1 and pow(w, 32, R_MOD) != 1


@pytest.mark.parametrize("l", [1, 2, 8])
def test_sharing_maps(l):
    m = pss.maps(l)
    n = 8 * l
    rng = random.Random(l)
    secrets = [rng.randrange(R_MOD) for _ in range(l)]
    shares = [sum(m["pack"][j][i] * secrets[i] for i in range(l)) % R_MOD for j in range(n)]
    assert [sum(m["unpack"][i][j] * shares[j] for j in range(n)) % R_MOD for i in range(l)] == secrets
    # products of two sharings unpack with unpack2
    other = [rng.randrange(R_MOD) for _ in range(l)]
    shares2 = [sum(m["pack"][j][i] * other[i] for i in range(l)) % R_MOD for j in range(n)]
    prod = [a * b % R_MOD for a, b in zip(shares, shares2)]
    assert [sum(m["unpack2"][i][j] * prod[j] for j in range(n)) % R_MOD
            for i in range(l)] == [a * b % R_MOD for a, b in zip(secrets, other)]
    # a single secret's shares unpack to [s, 0, ..., 0]
    single = [u * 5 % R_MOD for u in m["single"]]
    assert [sum(m["unpack"][i][j] * single[j] for j in range(n)) % R_MOD
            for i in range(l)] == [5] + [0] * (l - 1)


def test_generator_table():
    t = g1.GeneratorTable()
    assert g1.same_point(t.mul(1), (g1.GEN[0], g1.GEN[1], 1))
    acc = g1.INF
    for k in range(1, 20):
        acc = g1._add_affine(acc, g1.GEN)
        assert g1.same_point(t.mul(k), acc)
    x, y = g1._affine(t.mul(R_MOD - 1))
    assert g1.on_curve(x, y) and x == g1.GEN[0] and y == (-g1.GEN[1]) % g1.Q_MOD
    assert t.mul(R_MOD)[2] == 0


def test_srs_logs_name_the_programs_points():
    from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
    from scalable_collaborative_zksnark_tpu_torch.primitives.poly_comm import srs_random

    curve = bls12_381_g1("cpu")
    built = srs_random(curve, 4, 1 + 23, n_parties=8, packed_parties=16, max_level=3)
    table = g1.GeneratorTable()

    def same(pts, logs):
        xs = [int(v) for v in curve.fq.array_to_ints(pts.x).reshape(-1)]
        ys = [int(v) for v in curve.fq.array_to_ints(pts.y).reshape(-1)]
        zs = [int(v) for v in curve.fq.array_to_ints(pts.z).reshape(-1)]
        ks = F.to_ints(logs).reshape(-1)
        return all(g1.same_point((x, y, z), table.mul(int(k))) for x, y, z, k in zip(xs, ys, zs, ks))

    powers = srs.level_logs(F, [1 << k for k in range(4)], 1 + 23)
    assert all(same(p, lg) for p, lg in zip(built.powers_of_g, powers))
    roots = srs.level_logs(F, [1 << j for j in range(3)], 1 + 23 + 101)
    assert all(same(p, lg) for p, lg in zip(built.root_levels, roots))
    packed = srs.level_logs(F, [max((1 << k) // 2, 1) for k in range(5)], 1 + 23 + 211)
    assert all(same(p, lg) for p, lg in zip(built.packed_powers, packed))
