"""Shared by the readers of the protocol-primitive layer and of the host's
waits (``host_syncs``, ``device_s.*``, ``idle_s.*``): jobs of the run's
cell proved once more after the check, with the program's recorder on
(``utils/timer.py``), read against profiles of them.

The traced run's own profiles keep neither the recorder's records nor
kineto's correlation ids, so these readers measure jobs of their own: a
fresh ``System`` on the checkout's cached SRS and the run's fixed tables,
one warm-up job, then with the recorder on PROFILED_JOBS jobs under a
profile that records the device's activity (and the CUDA runtime's calls)
and one job with the host's operations recorded too (the labelled job).
Their tables come from a fixed seed: the work a prove asks does not
depend on the values.  The recorder's span times and kineto's events are
on one clock (unix ns), so each device op is joined to its launch by
kineto's correlation id, and each launch to the innermost family span
open on the host when it was made (``account``):

* device seconds by family, from the labelled job: the union of the
  job's device intervals, each instant given to the op that covers it
  first, so that the families and "outside" sum to the busy time;
* idle seconds by family, from the device-only jobs: each gap in a job's
  window (from the job's start on the host to the later of its end and
  its last device op's end) given to the family span open where the host
  launched the op that ended the gap ("outside" where none is, and for a
  gap no op ends), so that they sum to the idle time;
* host syncs: the ``sync.*`` counters a measured job.

A program without the recorder, or a run without a card, reads nothing;
a fault in the readers' jobs ends the run.  What a measurement finds is
printed on standard error as one line, ``primitives: {...}`` (with the
syncs by site and the check of the sums).  The recorder's own checks
(the clock, the syncs no counter accounts for) are the port's
``scripts/check_recorder.py``.
"""

import bisect
import json
import re
import sys
import time

OUTSIDE = "outside"
PROFILED_JOBS = 2
DEVICE = "cuda"
"""Where the readers' jobs run (the CPU in the benchmark's own tests)."""
SEED = 1
FIRST_STREAM = 1 << 20
"""The readers' jobs' streams: the warm-up, then one a job."""
CALL = re.compile(r"^cu(da)?[A-Z]")
"""A CUDA API call's name (``cuda...`` or ``cu...``)."""


def innermost(intervals, times) -> list[int]:
    """For each of ``times``, the index in ``intervals`` [(start, end)] of
    the innermost one open at it (start <= t < end), or -1.  The intervals
    nest, as one host thread's spans do."""
    order = sorted(range(len(intervals)), key=lambda i: (intervals[i][0], -intervals[i][1]))
    out = [-1] * len(times)
    stack, i = [], 0
    for k in sorted(range(len(times)), key=lambda k: times[k]):
        t = times[k]
        while i < len(order) and intervals[order[i]][0] <= t:
            while stack and intervals[stack[-1]][1] <= intervals[order[i]][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and intervals[stack[-1]][1] <= t:
            stack.pop()
        out[k] = stack[-1] if stack else -1
    return out


def families_at(spans, times) -> list[str]:
    """The family of the innermost family span open at each of ``times``,
    else OUTSIDE."""
    fam = [s for s in spans if s.family is not None]
    idx = innermost([(s.start_ns, s.end_ns) for s in fam], times)
    return [fam[i].family if i >= 0 else OUTSIDE for i in idx]


def job_windows(spans) -> list[tuple[int, int]]:
    """Each job's outermost span, (start, end), in start order."""
    roots = {}
    for s in spans:
        if s.job is not None:
            r = roots.get(s.job)
            if r is None or (s.start_ns, -s.end_ns) < (r[0], -r[1]):
                roots[s.job] = (s.start_ns, s.end_ns)
    return sorted(roots.values())


def account(ops, spans, keys) -> tuple[dict, dict, int]:
    """(device ns by key, idle ns by key, jobs) over the jobs of ``spans``.
    ``ops``: device intervals (start, end, launch), launch the host time of
    the call that made the op or None (then its start stands in).  An op
    belongs to the job whose window holds its launch; ops of no job are
    left out."""
    windows = job_windows(spans)
    starts = [w[0] for w in windows]
    device = dict.fromkeys(keys, 0)
    idle = dict.fromkeys(keys, 0)
    when = [a if launch is None else launch for a, _, launch in ops]
    per_job = [[] for _ in windows]
    for (a, b, _), t, fam in zip(ops, when, families_at(spans, when)):
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t <= windows[j][1]:
            per_job[j].append((a, b, fam))
    for (ws, we), jops in zip(windows, per_job):
        cover = ws  # the window is accounted for up to here
        for a, b, fam in sorted(jops):
            if a > cover:
                idle[fam] += a - cover  # the gap this op's launch ended
                cover = a
            if b > cover:
                device[fam] += b - cover
                cover = b
        if we > cover:
            idle[OUTSIDE] += we - cover
    return device, idle, len(windows)


def host_syncs(counters) -> tuple[float | None, dict]:
    """(sync.* counts a job, mean over the jobs; the same by counter)."""
    jobs = [c for job, c in counters.items() if job is not None]
    if not jobs:
        return None, {}
    sites = sorted({k for c in jobs for k in c if k.startswith("sync.")})
    by_site = {k: sum(c.get(k, 0) for c in jobs) / len(jobs) for k in sites}
    return sum(by_site.values()), by_site


def _ops(prof, names=()) -> list:
    """The device ops [(start, end, launch)] of a finished profile.  An
    event on the device is an op unless it annotates one of ``names`` on
    the device's timeline; its launch is the earliest CUDA API call of its
    correlation id, a call being named ``cuda...`` or ``cu...`` (kineto's
    events carry no kind on every torch version)."""
    from torch.autograd import DeviceType

    launch, raw = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in names:
                raw.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                            e.linked_correlation_id()))
        elif CALL.match(e.name()):
            c, t = e.correlation_id(), e.start_ns()
            if c and (c not in launch or t < launch[c]):
                launch[c] = t
    return [(a, b, launch.get(c, launch.get(lc))) for a, b, c, lc in raw]


def windows_by_start(ops, spans) -> tuple[int, int]:
    """(busy ns, idle ns) of the jobs' windows with each op put in the job
    in whose window it starts on the device (no launch joined): the check
    on ``account``'s sums."""
    windows = job_windows(spans)
    busy = idle = 0
    for j, (ws, we) in enumerate(windows):
        nxt = windows[j + 1][0] if j + 1 < len(windows) else None
        ivs = sorted((a, b) for a, b, _ in ops if a >= ws and (nxt is None or a < nxt))
        covered, end, cover = 0, we, ws
        for a, b in ivs:
            a = max(a, cover)
            if b > a:
                covered += b - a
                cover = b
            end = max(end, b)
        busy += covered
        idle += end - ws - covered
    return busy, idle


def _measure(ctx, timer) -> dict:
    import torch

    from zkbench import harness, traffic

    cell = ctx["cell"]
    cuda, cpu = torch.profiler.ProfilerActivity.CUDA, torch.profiler.ProfilerActivity.CPU
    t0 = time.perf_counter()
    static = traffic.static(cell.cfg, cell.traffic, SEED, DEVICE)
    system = cell.adapter.System(cell.cfg, cell.traffic, static, DEVICE,
                                 cell.man.root / harness.CACHE)

    def jobs(first, count):
        for k in range(first, first + count):
            stream = FIRST_STREAM + k
            fresh = traffic.fresh(cell.cfg, cell.traffic, SEED, stream, DEVICE)
            system.prove(fresh, traffic.prover_seed(SEED, stream))
            harness._sync(DEVICE)

    try:
        jobs(0, 1)  # warm-up: the allocator's blocks
        timer.clear()
        timer.enable(True, show=False)
        try:
            with torch.profiler.profile(activities=[cuda]) as prof:
                jobs(1, PROFILED_JOBS)
            first = {s.job for s in timer.spans()}
            with torch.profiler.profile(activities=[cpu, cuda]) as prof2:
                jobs(1 + PROFILED_JOBS, 1)
            spans, counters = timer.spans(), timer.counters()
        finally:
            timer.enable(False)
            timer.clear()
    finally:
        system.close()
        del system, static
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dev_spans = [s for s in spans if s.job in first]
    lab_spans = [s for s in spans if s.job not in first]
    keys = timer.FAMILIES + (OUTSIDE,)
    names = {s.name.replace(" ", "_") for s in spans}
    ops, ops2 = _ops(prof, names), _ops(prof2, names)
    _, dev_i, n_dev = account(ops, dev_spans, keys)
    lab_d, _, n_lab = account(ops2, lab_spans, keys)
    per = lambda d, n: {k: v / n / 1e9 for k, v in d.items()}  # noqa: E731
    syncs, by_site = host_syncs(counters)
    busy_chk, _ = windows_by_start(ops2, lab_spans)
    _, idle_chk = windows_by_start(ops, dev_spans)
    found = {
        "jobs": {"device_only": n_dev, "labelled": n_lab},
        "spans_a_job": len(spans) / max(n_dev + n_lab, 1),
        "device_s": per(lab_d, n_lab), "idle_s": per(dev_i, n_dev),
        "busy_s": sum(lab_d.values()) / n_lab / 1e9,
        "idle_total_s": sum(dev_i.values()) / n_dev / 1e9,
        "launches_joined": [sum(o[2] is not None for o in ops2), len(ops2)],
        "host_syncs": syncs, "syncs_by_site": by_site,
        "check": {"busy_s": busy_chk / n_lab / 1e9, "idle_s": idle_chk / n_dev / 1e9},
        "seconds": [t1 - t0, time.perf_counter() - t1],
    }
    print("primitives: " + json.dumps(found), file=sys.stderr, flush=True)
    return found


def measure(ctx):
    """What the readers read, measured once a run (kept in ``ctx``); None
    without a card or without the program's recorder.  A fault in the
    readers' jobs is raised, not read as nothing."""
    if "primitives" in ctx:
        return ctx["primitives"]
    ctx["primitives"] = None
    if ctx.get("trace") is None or "cell" not in ctx:
        return None
    from scalable_collaborative_zksnark_tpu_torch.utils import timer

    if not hasattr(timer, "spans"):
        return None
    ctx["primitives"] = _measure(ctx, timer)
    return ctx["primitives"]

