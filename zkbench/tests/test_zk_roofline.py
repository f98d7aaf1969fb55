"""The roofline and idle arithmetic on fixed shapes and a synthetic trace."""

import pytest
import torch

from zkbench import manifest, roofline, tracing
from zkbench.tests.conftest import REPO

PEAKS = roofline.Peaks(sm_count=132, clock_mhz=1980.0, power_limit_w=700.0)


def test_peaks():
    assert PEAKS.imad_per_s == 64 * 132 * 1980e6
    assert PEAKS.bytes_per_s == 3.35e12


def test_field_op_bounds():
    # a 2^20 Fr product: 264 multiply-adds an element vs 96 bytes: bytes bound
    s = roofline.field_op(PEAKS, "fr", "mul", 1 << 20, 1 << 20, 1 << 20)
    assert s == pytest.approx(3 * 32 * (1 << 20) / 3.35e12)
    # a broadcast constant counts once
    s = roofline.field_op(PEAKS, "fq", "add", 1, 1 << 10, 1 << 10)
    assert s == pytest.approx((1 + 2 * 1024) * 48 / 3.35e12)
    # a product of two single elements is compute bound
    s = roofline.field_op(PEAKS, "fq", "mul", 1, 1, 1)
    assert s == pytest.approx(max(588 / PEAKS.imad_per_s, 3 * 48 / 3.35e12))


def test_msm_least_work():
    # one point: the best window is c = 1 (255 windows of a mixed add and 2 adds)
    assert roofline.msm_fq_products(1) == min(
        -(-255 // c) * (11 + (1 << c) * 16) + 255 * 7 for c in range(1, 25))
    big = roofline.msm_fq_products(1 << 21)
    assert big == min(-(-255 // c) * ((1 << 21) * 11 + (1 << c) * 16) + 255 * 7
                      for c in range(1, 25))
    # more points never cost less, and per point it falls
    assert roofline.msm_fq_products(1 << 20) < big < 2 * roofline.msm_fq_products(1 << 20)
    s = roofline.msm(PEAKS, 3, 1 << 21)
    assert s == pytest.approx(3 * big * 588 / PEAKS.imad_per_s)


def _events():
    """Window 0-1000 us, bounded by the marker ops at 0-1 and 999-1000:
    kernels 100-300 (g1), 250-400 (field), 700-800 (other); host ops cover
    the gaps."""
    w = {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW_LABEL, "ts": 0, "dur": 1000,
         "pid": 1, "tid": 7}
    k = lambda ts, dur, name: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,  # noqa: E731
                               "pid": 0, "tid": 9}
    h = lambda ts, dur, name: {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,  # noqa: E731
                               "pid": 1, "tid": 7}
    return [w, dict(w, cat="gpu_user_annotation", pid=0, tid=9), k(0, 1, "marker"),
            k(999, 1, "marker"), k(100, 200, "void add_team_kernel<12>(...)"), k(250, 150, "void binary_kernel<0>(...)"),
            k(700, 100, "void at::native::elementwise_kernel(...)"),
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 900, "dur": 10,
             "pid": 0, "tid": 9},
            h(0, 999, "outer"), h(400, 300, "aten::item"), h(450, 10, "cudaStreamSynchronize"),
            {"ph": "X", "cat": "cpu_op", "name": "other thread", "ts": 0, "dur": 1000, "pid": 1,
             "tid": 8}]


def test_trace_busy_idle_and_gaps():
    t = tracing.Trace(_events(), jobs=2)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((300 + 100 + 10) * 1e-6)
    assert len(t.kernels()) == 3
    assert t.kernel_seconds(["add_team_kernel"]) == pytest.approx(200e-6)
    assert t.gaps() == [(0.0, 100.0), (400.0, 700.0), (800.0, 900.0), (910.0, 1000.0)]
    # the idle gaps of another (labelled) trace: there no aten::item
    other = tracing.Trace([e for e in _events() if e["name"] != "aten::item"], jobs=1)
    assert t.breakdown(other)["idle_gaps"] == [["outer", pytest.approx(590e-6)]]
    b = t.breakdown()
    assert b["device_ops"][0] == ["void add_team_kernel<12>(...)", pytest.approx(200e-6)]
    # idle time by the host op open as each gap began: 300 us in aten::item,
    # 100 + 100 + 90 us in "outer"
    assert b["idle_gaps"] == [["aten::item", pytest.approx(300e-6)],
                              ["outer", pytest.approx(290e-6)]]


def test_readers_on_the_synthetic_trace():
    man = manifest.Manifest(REPO)
    t = tracing.Trace(_events(), jobs=2)
    work = tracing.WorkLog(PEAKS)
    work.g1_s, work.field_s = 25e-6, 37.5e-6  # one job's: the trace holds two
    ctx = {"trace": t, "work": work, "spans": {"wire": 0.5, "commit_open": 0.25},
           "comm": [(10, 20, 3), (10, 20, 3)], "jobs": 2, "window_s": 3.0}
    assert man.reader("prove_wall_s")(ctx) == 1.5
    assert man.reader("device_kernels")(ctx) == 1.5
    assert man.reader("g1_roofline")(ctx) == pytest.approx(25.0)
    assert man.reader("field_roofline")(ctx) == pytest.approx(50.0)
    assert man.reader("step_s.wire")(ctx) == 0.5
    assert man.reader("step_s.commit_open")(ctx) == 0.25
    assert man.reader("comm_MB")(ctx) == pytest.approx(30e-6)
    # nothing to read: no value, never 0
    empty = {"trace": None, "work": None, "spans": {}, "comm": [], "jobs": 0}
    for m in man.data["per_layer"]:
        assert man.reader(m["name"])(empty) is None


def test_worklog_counts_at_entry_points():
    from scalable_collaborative_zksnark_tpu_torch.curves.g1 import bls12_381_g1
    from scalable_collaborative_zksnark_tpu_torch.primitives import msm as msm_mod

    curve = bls12_381_g1("cpu")
    F = curve.fr
    work = tracing.WorkLog(PEAKS)
    a = F.random((4,), 1)
    with work.patched():
        F.mul(a, a)
        assert work.field_s == pytest.approx(roofline.field_op(PEAKS, "fr", "mul", 4, 4, 4))
        g = curve.from_affine_ints([(int(x), int(y)) for x, y in [
            (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
             0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)]])
        before = work.g1_s
        curve.double(g)
        assert work.g1_s - before == pytest.approx(roofline.point_op(PEAKS, 7, 1, 1))
        before = work.g1_s
        scal = torch.zeros((3, 16), dtype=torch.int32)
        scal[:, 0] = torch.tensor([1, 2, 3])
        pts = type(g)(*(c.expand(3, c.shape[-1]) for c in g))
        msm_mod.msm(curve, pts, scal)  # the naive path's point ops are the MSM's own
        assert work.g1_s - before == pytest.approx(roofline.msm(PEAKS, 1, 3))
    assert msm_mod.msm.__name__ == "msm"
