"""The arithmetic of the protocol-primitive readers (``metrics/_primitives.py``)
on a synthetic job: recorder spans and device ops on one clock (ns)."""

import importlib.util

import pytest

from scalable_collaborative_zksnark_tpu_torch.utils import timer
from scalable_collaborative_zksnark_tpu_torch.utils.timer import Span
from zkbench import manifest
from zkbench.tests.conftest import REPO

_spec = importlib.util.spec_from_file_location(
    "zkbench_metrics_primitives", REPO / "zkbench" / "metrics" / "_primitives.py")
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)
KEYS = timer.FAMILIES + (P.OUTSIDE,)


def _job(job, t0):
    """One job's spans from ``t0``: the prove 0-1000, a step 100-900 with an
    msm span 100-400 inside a pcs span 100-500, a sumcheck span 600-800."""
    r, s = 10 * job, t0
    return [Span("dhyperplonk", r, None, job, None, s, s + 1000),
            Span("Wire identity", r + 1, r, job, None, s + 100, s + 900),
            Span("c_commit", r + 2, r + 1, job, "pcs", s + 100, s + 500),
            Span("msm_ragged", r + 3, r + 2, job, "msm", s + 100, s + 400),
            Span("c_sumcheck_product", r + 4, r + 1, job, "sumcheck", s + 600, s + 800)]


def test_innermost_and_families():
    spans = _job(1, 0)
    times = [50, 150, 450, 550, 700, 950, 2000]
    assert P.families_at(spans, times) == ["outside", "msm", "pcs", "outside", "sumcheck",
                                           "outside", "outside"]
    idx = P.innermost([(s.start_ns, s.end_ns) for s in spans], times)
    assert [spans[i].name if i >= 0 else None for i in idx] == [
        "dhyperplonk", "msm_ragged", "c_commit", "Wire identity", "c_sumcheck_product",
        "dhyperplonk", None]
    assert P.job_windows(spans + _job(2, 5000)) == [(0, 1000), (5000, 6000)]


def test_device_time_goes_to_the_launching_span():
    spans = _job(1, 0)
    # (start, end, launch): the first op runs after its msm launch has
    # closed; two ops overlap; one op has no launch joined (its start
    # stands in); one belongs to no job
    ops = [(420, 520, 380), (450, 470, 390), (650, 700, 610), (705, 760, None),
           (-300, -200, -350)]
    device, idle, jobs = P.account(ops, spans, KEYS)
    assert jobs == 1
    assert device == {"msm": 100, "sumcheck": 105, "pcs": 0, "acc_product": 0, "pss": 0,
                      "outside": 0}
    # every device instant once: the sums are the union of the job's ops
    busy, idle_chk = P.windows_by_start(ops, spans)
    assert sum(device.values()) == busy == 100 + 50 + 55
    assert sum(idle.values()) == idle_chk == 1000 - busy


def test_each_gap_goes_to_the_span_that_ended_it():
    spans = _job(1, 0)
    ops = [(420, 520, 380), (650, 700, 610), (705, 760, 790)]
    _, idle, _ = P.account(ops, spans, KEYS)
    # 0-420 ended by an msm launch, 520-650 by a sumcheck one, 700-705 by
    # one at 790 (sumcheck), 760-1000 by the job's end (outside)
    assert idle == {"msm": 420, "sumcheck": 130 + 5, "pcs": 0, "acc_product": 0, "pss": 0,
                    "outside": 240}
    # a device op that outlives the job's host span stretches its window
    _, idle, _ = P.account([(1000, 1300, 950)], spans, KEYS)
    assert idle["outside"] == 1000 and sum(idle.values()) == 1000


def test_jobs_are_accounted_apart():
    spans = _job(1, 0) + _job(2, 5000)
    ops = [(420, 520, 380), (5420, 5520, 5380), (3000, 3100, 3000)]
    device, idle, jobs = P.account(ops, spans, KEYS)
    assert jobs == 2 and device["msm"] == 200 and sum(device.values()) == 200
    assert sum(idle.values()) == 2 * 1000 - 200


def test_host_syncs_a_job():
    counters = {None: {"sync.normalize": 99}, 1: {"sync.normalize": 10, "sync.upload.r2": 2},
                2: {"sync.normalize": 12, "sync.upload.r2": 2, "other": 5}}
    total, by_site = P.host_syncs(counters)
    assert by_site == {"sync.normalize": 11.0, "sync.upload.r2": 2.0} and total == 13.0
    assert P.host_syncs({}) == (None, {})


@pytest.mark.parametrize("ctx", [{"trace": None, "work": None, "spans": {}, "comm": [], "jobs": 0},
                                 {"trace": object(), "spans": {}, "comm": [], "jobs": 1}])
def test_readers_read_nothing_without_a_card_or_cell(ctx):
    man = manifest.Manifest(REPO)
    for name in ("host_syncs", "device_s.msm", "device_s.sumcheck", "idle_s.msm",
                 "idle_s.sumcheck", "idle_s.outside_primitives"):
        assert man.reader(name)(dict(ctx)) is None


def test_readers_read_nothing_from_a_program_without_the_recorder(monkeypatch):
    monkeypatch.delattr(timer, "spans")
    ctx = {"trace": object(), "cell": object()}
    assert manifest.Manifest(REPO).reader("host_syncs")(ctx) is None


def test_the_readers_jobs_on_the_cpu(tiny_root, monkeypatch):
    """The readers' own jobs end to end at 2^4 gates on the CPU, with the G1
    point operations faked (their values are not read) and a profile of
    the host in place of the device's: every job is found and counted, and
    the clock check pairs every span with its annotation."""
    import torch

    from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
    from zkbench import harness
    from zkbench.tests.conftest import TINY_CELL

    def add(spec, p1, p2, mixed=False):
        out = tuple(a ^ b for a, b in zip(p1, p2))
        return out, torch.zeros(out[0].shape[:-1], dtype=torch.bool)

    real = torch.profiler.profile
    monkeypatch.setattr(cuda_g1, "add_plain", add)
    monkeypatch.setattr(cuda_g1, "double_plain", lambda spec, pt: tuple(a.clone() for a in pt))
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: real(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(P, "DEVICE", "cpu")
    found = P.measure({"trace": object(), "cell": harness.Cell(tiny_root, TINY_CELL)})
    assert found["jobs"] == {"device_only": P.PROFILED_JOBS, "labelled": 1}
    assert found["spans_a_job"] == 52
    assert found["host_syncs"] == sum(found["syncs_by_site"].values()) > 0
    assert found["busy_s"] == 0 and found["idle_total_s"] > 0  # no device ops on the CPU
    assert found["idle_s"][P.OUTSIDE] == found["idle_total_s"]
    assert not timer.spans() and not timer.counters()

