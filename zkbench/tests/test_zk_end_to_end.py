"""The harness end to end against the plain reference at a tiny size on the
CPU (a leader of 8 servers, l = 1, 2^4 gates), through its test-only path
``harness.run(..., device="cpu")``; then the same run with the timed path
broken underneath, which has to come out not correct.  Each run proves
twice on the CPU's plain kernels: minutes."""

import json

import pytest
import torch

from zkbench import control, harness
from zkbench.reference import g1
from zkbench.tests.conftest import TINY_CELL, make_root

SEED = 3_000_000_123  # wider than 31 bits, as a run's seed may be


def _run(root, trace=False):
    return harness.run(root, TINY_CELL, SEED, 0.01, trace, device="cpu")


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    return _run(make_root(tmp_path_factory.mktemp("clean")))


def test_clean_run_is_correct(clean):
    assert clean["correct"] is True
    assert clean["failed"] == 0 and clean["attempted"] >= 1
    assert clean["compared"]["bundle_mismatches"] == {"value": 0, "limit": 0}
    assert clean["compared"]["comm_mismatches"] == {"value": 0, "limit": 0}
    # on the CPU there is no device trace: prove_device_s is left out, not 0
    assert set(clean["metrics"]) == {"peak_mem_GB", "setup_s"}
    assert all(v["value"] >= 0 for v in clean["metrics"].values())
    assert clean["device"]["platform"] == "cpu"


def test_last_line(clean, capsys):
    harness.emit(clean)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert err.strip().splitlines()[-2:] == [
        "compared bundle_mismatches = 0 (limit 0)", "compared comm_mismatches = 0 (limit 0)"]


def test_traced_run_reads_spans_and_counters(tmp_path):
    r = _run(make_root(tmp_path), trace=True)
    assert r["correct"] is True
    # on the CPU there is no device trace: those metrics are left out, not 0
    assert set(r["metrics"]) == {"prove_wall_s", "step_s.wire", "step_s.commit_open", "comm_MB"}
    assert r["metrics"]["prove_wall_s"]["value"] > 0
    # party 0's bytes a (4, 1) leader prove (the JAX package's pins)
    assert r["metrics"]["comm_MB"]["value"] == pytest.approx((44465 + 46593) / 1e6)
    assert "breakdown" not in r and "busy_s" not in r["device"]


def test_the_control_fails(tmp_path):
    r = control.readings(make_root(tmp_path), TINY_CELL, SEED, "cpu", g1.GeneratorTable())
    assert r["bundle_mismatches"] > 0


def _answer_altered(monkeypatch):
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative

    orig = collaborative.c_sumcheck_product

    def altered(*args):
        out = orig(*args).clone()
        out[..., 0, 0, 0] ^= 1
        return out
    monkeypatch.setattr(collaborative, "c_sumcheck_product", altered)


def _fold_keeps_its_state(monkeypatch):
    from scalable_collaborative_zksnark_tpu_torch.primitives import poly_comm

    def unchanged(F, cur, point, start, count):
        qs = []
        for _ in range(count):
            half = cur.shape[-2] // 2
            lo, hi = cur[..., :half, :], cur[..., half:, :]
            qs.append(F.sub(hi, lo))
            cur = lo  # the challenge never moves the table
        return qs, cur
    monkeypatch.setattr(poly_comm, "_fold_rounds", unchanged)


def _half_the_batch(monkeypatch):
    from scalable_collaborative_zksnark_tpu_torch.hyperplonk import collaborative

    orig = collaborative.c_sumcheck_product

    def half(pp, net, f, g, ch):
        if f.ndim == 4 and f.shape[1] > 1:  # [P, B, M, L]: prove half, copy it over the rest
            h = f.shape[1] // 2
            out = orig(pp, net, f[:, :h], g[:, :h], ch)
            return torch.cat([out, out], dim=1)[:, :f.shape[1]]
        return orig(pp, net, f, g, ch)
    monkeypatch.setattr(collaborative, "c_sumcheck_product", half)


@pytest.mark.parametrize("fault", [_answer_altered, _fold_keeps_its_state, _half_the_batch],
                         ids=["answer_altered", "state_unchanged", "half_the_batch"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    r = _run(make_root(tmp_path))
    assert r["correct"] is False
    assert r["failed"] >= 1
