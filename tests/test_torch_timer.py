"""The port's recorder of spans and counters (``utils/timer.py``) over whole
leader proves at n = 4, l = 1 on the CPU.

The G1 layer's plain versions take about a minute a prove here, so the
module swaps the two point operations underneath them (``add_plain``,
``double_plain``) for cheap stand-ins of the same shapes: the proves
take the port's every path and call, not its values, which these tests
do not read.
"""

import contextlib

import pytest
import torch

from scalable_collaborative_zksnark_tpu_torch.curves import cuda_g1
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.collaborative import dhyperplonk
from scalable_collaborative_zksnark_tpu_torch.hyperplonk.params import packed_proving_parameters
from scalable_collaborative_zksnark_tpu_torch.mpc.net import PartyNet
from scalable_collaborative_zksnark_tpu_torch.scripts import check_recorder
from scalable_collaborative_zksnark_tpu_torch.utils import timer

N, L = 4, 1
STEPS = {"Distributed HyperPlonk", "Commit", "Distributed HyperPlonk Prover", "Gate identity",
         "Wire identity", "Local: calculate den, num and h_p", "Leader: Compute leader tree",
         "Open"}
"""The leader prove's ``trace`` spans."""


def _add(spec, p1, p2, mixed=False):
    out = tuple(a ^ b for a, b in zip(p1, p2))
    return out, torch.zeros(out[0].shape[:-1], dtype=torch.bool)


@pytest.fixture(scope="module")
def prove():
    """A function that runs one leader prove on fixed inputs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_g1, "add_plain", _add)
        mp.setattr(cuda_g1, "double_plain", lambda spec, pt: tuple(a.clone() for a in pt))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        net = PartyNet(8 * L, "leader")
        pk = packed_proving_parameters(N, L, net, device="cpu")
        try:
            yield lambda: dhyperplonk(N, pk, net)
        finally:
            torch.set_num_threads(threads)


@contextlib.contextmanager
def _recording():
    timer.clear()
    timer.enable(True, show=False)
    try:
        yield
    finally:
        timer.enable(False)


@pytest.fixture(scope="module")
def recorded(prove):
    """The spans and counters of two proves with the recorder on, the
    first switched on by ``enable``, the second by a timed window whose
    sync function logs its calls; and those calls."""
    calls = []
    with _recording():
        prove()
    timer.set_sync(lambda: calls.append(1))
    try:
        with timer.span("a primitive", "msm"):
            pass
        prove()
    finally:
        timer.set_sync(None)
    out = [s for s in timer.spans() if s.name != "a primitive"], timer.counters(), calls
    timer.clear()
    return out


def test_off_keeps_nothing_and_enters_no_record_function(prove, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        entered.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer.clear()
    prove()
    assert timer.spans() == [] and timer.counters() == {} and timer.records() == []
    assert entered == []


def test_spans_nest_as_the_call_tree(recorded):
    spans, _, _ = recorded
    jobs = sorted({s.job for s in spans})
    assert len(jobs) == 2 and None not in jobs
    by_id = {s.id: s for s in spans}
    for job in jobs:
        mine = [s for s in spans if s.job == job]
        roots = [s for s in mine if s.parent is None]
        assert [r.name for r in roots] == ["dhyperplonk"]
        for s in mine:  # each span lies inside its parent, in the same job
            if s.parent is not None:
                p = by_id[s.parent]
                assert p.job == job and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        names = {s.name for s in mine}
        assert STEPS | {"placeholders", "c_commit", "msm_ragged", "d_open_many",
                        "c_sumcheck_product", "pss2ss", "d_acc_product"} <= names
        assert {s.family for s in mine} == set(timer.FAMILIES) | {None}
        assert len(mine) < 100  # no span inside a per-round loop
    # the calls nest as the code calls them
    parents = {(by_id[s.parent].name, s.name) for s in spans if s.parent is not None}
    assert {("dhyperplonk", "placeholders"), ("Commit", "c_commit"),
            ("c_commit", "msm_ragged"), ("Wire identity", "_exchange_s"),
            ("Gate identity", "c_sumcheck_product"), ("c_sumcheck_product", "pss2ss"),
            ("d_open_many", "msm_ragged")} <= parents


def test_self_time_is_the_duration_less_the_children(recorded):
    spans, _, _ = recorded
    own = timer.self_ns(spans)
    root = next(s for s in spans if s.name == "dhyperplonk")
    kids = [s for s in spans if s.parent == root.id]
    assert own[root.id] == root.end_ns - root.start_ns - sum(k.end_ns - k.start_ns for k in kids)
    assert sum(own[s.id] for s in spans if s.job == root.job) == root.end_ns - root.start_ns
    assert min(own.values()) >= 0


def test_sync_counters_repeat_prove_to_prove(recorded):
    _, counters, _ = recorded
    first, second = (counters[j] for j in sorted(counters))
    assert first == second and set(first) >= {"sync.normalize", "sync.upload.field",
                                              "sync.msm_repeat", "msm.dense_passes"}
    assert all(k.startswith(("sync.", "msm.")) and v > 0 for k, v in first.items())
    assert first["msm.dense_lanes"] >= first["msm.dense_passes"]


def test_set_sync_is_called_at_trace_edges_only(recorded):
    spans, _, calls = recorded
    window = max(s.job for s in spans)
    steps = [s for s in spans if s.job == window and s.name in STEPS]
    assert len(calls) == 2 * len(steps) == 2 * len(STEPS)

def _job():
    """A prove's shape in small: a job, a step, a primitive, two waits."""
    with timer.span("dhyperplonk", job=True):
        with timer.trace("Wire identity"):
            with timer.span("c_commit", "pcs"):
                timer.count("sync.upload.field", 2)
                timer.count("launches")


def _annotations(run) -> list[str]:
    """The names of the host's annotations in a profile of ``run()``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name() in ("dhyperplonk", "Wire_identity", "c_commit")]


def test_trace_annotates_a_running_profile_while_off():
    """Off, a profile still sees the protocol's steps, and only them;
    nothing is kept."""
    timer.clear()
    assert _annotations(_job) == ["Wire_identity"]
    assert timer.spans() == [] and timer.counters() == {}
    with _recording():
        assert sorted(_annotations(_job)) == ["Wire_identity", "c_commit", "dhyperplonk"]
    timer.clear()


def test_set_sync_none_toggles_the_window():
    """``set_sync(None)`` opens a window that syncs nothing when none is
    open, and closes the open one otherwise (its docstring's hazard)."""
    calls = []
    assert not timer._ON
    try:
        timer.set_sync(None)
        assert timer._ON and timer._SYNC is None
        timer.set_sync(None)
        assert not timer._ON
        timer.set_sync(lambda: calls.append(1))
        timer.set_sync(lambda: calls.append(2))  # replaces the function
        assert timer._ON
        with timer.trace("Open"):
            pass
        assert calls == [2, 2]
        timer.set_sync(None)
        assert not timer._ON and timer._SYNC is None
    finally:
        timer._WINDOW, timer._SYNC = False, None
        timer._switch()
        timer.clear()


def test_check_recorder():
    """The recorder's checks: spans and annotations paired by name in start
    order; each counter pass covers the next sync; on the CPU, every span
    of a job has its annotation on the same clock, and no sync is made."""
    S = timer.Span
    spans = [S("dhyperplonk", 1, None, 1, None, 0, 1000), S("c_commit", 2, 1, 1, "pcs", 100, 500),
             S("Wire identity", 3, 1, 1, None, 100, 900)]
    notes = [("Wire_identity", 103, 905), ("c_commit", 96, 501), ("dhyperplonk", 1, 999),
             ("c_commit", 2000, 2001)]  # two of one name and one recorded: left out
    assert sorted(check_recorder.clock_offsets(spans, notes)) == sorted([-1, 1, -3, -5])
    # passes at 10 (a site that waits twice: two entries), 30, 50; syncs at
    # 12, 13 (the first site's), 20 (no pass), 31 (the second's), 60 (the
    # third's, late); a pass at 70 with no sync after it
    assert check_recorder.uncounted([10, 10, 30, 50, 70], [12, 13, 20, 31, 60]) == ([2], 1)
    assert check_recorder.uncounted([10, 20], [25]) == ([], 1)
    real = timer.count
    found = check_recorder.check(_job, cuda=False)
    assert timer.count is real and not timer._ON and timer.spans() == []
    assert found["spans"] == 3 and found["clock_us"]["edges"] == 6
    assert found["clock_us"]["worst"] < 50_000  # one clock: not seconds apart
    assert found["syncs"] == 0 and found["uncounted"] == []
    assert found["passes"] == found["passes_without_sync"] == 2
    assert found["syncs_by_site"] == {"sync.upload.field": 2}
