"""What a traced run reads besides the window's clock: the program's own
spans with the device synchronised at each edge; a profile of a few jobs
that records the device's activity alone (its busy and idle time, its
kernels); one job profiled with the host's operations recorded too, whose
idle gaps are labelled by what the host was doing; and one job, outside
any profiler, with the work the prove asks of the field and group layers
recorded at their entry points.  Recording host operations and patching
the entry points slow the host, so neither touches the jobs that busy
and idle time are read from.

Each profile's trace is written under the run's temporary directory, read
into a ``Trace`` and deleted.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

import torch

from . import roofline, traffic

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
WINDOW_LABEL = "zkbench_profiled_jobs"
PROFILED_JOBS = 2
"""Jobs in the device-only profile."""
JOBS = PROFILED_JOBS + 2
"""Jobs a traced run serves after its window: the device-only profile's,
the labelled one and the counted one."""


def span_window(system, cell, seed, device, seconds, window):
    """The window with the program's spans synchronised: ``window``'s
    result and the mean seconds a job of each span group of the adapter's
    ``SPANS``."""
    from scalable_collaborative_zksnark_tpu_torch.utils import timer

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else None
    timer.set_sync(sync)
    timer.clear()
    try:
        out = window(system, cell, seed, device, seconds, traffic.WINDOW)
        records = timer.records()
    finally:
        timer.set_sync(None)
        timer.clear()
    jobs = len(out[0])
    spans = {key: sum(s for label, s in records if label in labels) / jobs if jobs else None
             for key, labels in cell.adapter.SPANS.items()}
    return (*out, spans)


def device_window(system, cell, seed, device, seconds, window):
    """The window under a profile that records the device's activity
    alone: ``window``'s result and the seconds in which the device ran a
    kernel, a copy or a memset (the union of their intervals); None in
    place of the seconds on a machine without a card."""
    if torch.device(device).type != "cuda":
        return (*window(system, cell, seed, device, seconds, traffic.WINDOW), None)
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = window(system, cell, seed, device, seconds, traffic.WINDOW)
    t = time.perf_counter()
    spans = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    busy = sum(b - a for a, b in Trace._union(spans)) / 1e9
    print(f"device busy {busy:.4f} s in the window: {len(spans)} device intervals, read in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return (*out, busy)


class WorkLog:
    """Least seconds of the field and group work asked for, summed at the
    entry points: ``Field.mul/add/sub``, ``Curve.add/add_mixed/double/
    scalar_mul`` and the MSM functions ``msm`` and ``msm_ragged`` (the
    point operations inside an MSM are its own)."""

    def __init__(self, peaks: roofline.Peaks):
        self.peaks = peaks
        self.field_s = 0.0
        self.g1_s = 0.0
        self._in_msm = 0

    @staticmethod
    def _n(shape) -> int:
        return int(torch.Size(shape).numel())

    def _field(self, op):
        log = self

        def wrap(orig):
            def call(F, a, b):
                out = tuple(torch.broadcast_shapes(a.shape, b.shape))
                kind = "fr" if F.spec.name.endswith("_fr") else "fq"
                log.field_s += roofline.field_op(log.peaks, kind, op, log._n(a.shape[:-1]),
                                                 log._n(b.shape[:-1]), log._n(out[:-1]))
                return orig(F, a, b)
            return call
        return wrap

    def _point(self, products):
        log = self

        def wrap(orig):
            def call(curve, p1, p2):
                if not log._in_msm:
                    out = torch.broadcast_shapes(p1.x.shape[:-1], p2.x.shape[:-1])
                    log.g1_s += roofline.point_op(log.peaks, products,
                                                  log._n(p1.x.shape[:-1]) + log._n(p2.x.shape[:-1]),
                                                  log._n(out))
                return orig(curve, p1, p2)
            return call
        return wrap

    def _double(self, orig):
        log = self

        def call(curve, pt):
            if not log._in_msm:
                n = log._n(pt.x.shape[:-1])
                log.g1_s += roofline.point_op(log.peaks, roofline.DOUBLE, n, n)
            return orig(curve, pt)
        return call

    def _scalar_mul(self, orig):
        log = self

        def call(curve, pt, scalars):
            if not log._in_msm:
                lanes = log._n(torch.broadcast_shapes(pt.x.shape[:-1], scalars.shape[:-1]))
                bits = min(16 * scalars.shape[-1], roofline.SCALAR_BITS)
                log.g1_s += roofline.point_op(
                    log.peaks, (bits - 1) * roofline.DOUBLE, log._n(pt.x.shape[:-1]), lanes,
                    log._n(scalars.shape[:-1]) * roofline.FR_BYTES)
            return orig(curve, pt, scalars)
        return call

    def _msm(self, orig):
        log = self

        def call(curve, points, scalars, *args, **kwargs):
            if not log._in_msm:
                sb, pb = scalars.shape[:-2], points.x.shape[:-2]
                batch = sb if len(sb) >= len(pb) else pb
                log.g1_s += roofline.msm(log.peaks, log._n(batch), scalars.shape[-2])
            log._in_msm += 1
            try:
                return orig(curve, points, scalars, *args, **kwargs)
            finally:
                log._in_msm -= 1
        return call

    def _msm_ragged(self, orig):
        log = self

        def call(curve, bases_list, scalars_list, *args, **kwargs):
            if not log._in_msm:
                for s in scalars_list:
                    log.g1_s += roofline.msm(log.peaks, log._n(s.shape[:-2]), s.shape[-2])
            log._in_msm += 1
            try:
                return orig(curve, bases_list, scalars_list, *args, **kwargs)
            finally:
                log._in_msm -= 1
        return call

    @contextlib.contextmanager
    def patched(self):
        """The entry points wrapped for the duration of the block."""
        from scalable_collaborative_zksnark_tpu_torch.curves.g1 import Curve
        from scalable_collaborative_zksnark_tpu_torch.fields.fr import Field
        from scalable_collaborative_zksnark_tpu_torch.primitives import msm as msm_mod

        methods = [(Field, "mul", self._field("mul")), (Field, "add", self._field("add")),
                   (Field, "sub", self._field("sub")), (Curve, "add", self._point(roofline.ADD)),
                   (Curve, "add_mixed", self._point(roofline.MIXED)),
                   (Curve, "double", self._double), (Curve, "scalar_mul", self._scalar_mul)]
        funcs = [(msm_mod.msm, self._msm(msm_mod.msm)),
                 (msm_mod.msm_ragged, self._msm_ragged(msm_mod.msm_ragged))]
        saved = []
        for cls, name, wrap in methods:
            saved.append((cls, name, cls.__dict__[name]))
            setattr(cls, name, wrap(cls.__dict__[name]))
        port = "scalable_collaborative_zksnark_tpu_torch"
        for mod in [m for k, m in list(sys.modules.items()) if k.split(".", 1)[0] == port]:
            for attr, val in list(vars(mod).items()):
                for orig, wrapped in funcs:
                    if val is orig:
                        saved.append((mod, attr, val))
                        setattr(mod, attr, wrapped)
        try:
            yield self
        finally:
            for owner, name, val in reversed(saved):
                setattr(owner, name, val)


class Trace:
    """The device's and the host's intervals in one profiled window."""

    def __init__(self, events: list[dict], jobs: int):
        self.jobs = jobs
        device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                         e.get("name", ""), e.get("cat")) for e in events
                        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
        if len(device) < 3:
            raise ValueError("the profile holds no device activity between its markers")
        # the jobs run between two marker ops (``_jobs``), the first and the
        # last thing the device does: they bound the window and are no job's
        self.t0, self.t1 = device[0][0], device[-1][1]
        self.device = device[1:-1]
        win = [e for e in events if e.get("name") == WINDOW_LABEL and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        w = win[0] if win else None
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
                     for e in events if w is not None and e.get("ph") == "X"
                     and e.get("cat") in HOST_CATS
                     and e.get("pid") == w.get("pid") and e.get("tid") == w.get("tid")]
        self.busy = self._union([(a, b) for a, b, _, _ in self.device])

    @staticmethod
    def _union(iv):
        out = []
        for a, b in sorted(iv):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernels(self):
        return [(a, b, name) for a, b, name, cat in self.device if cat == "kernel"]

    def kernel_seconds(self, patterns) -> float:
        return sum(b - a for a, b, name in self.kernels() if any(p in name for p in patterns)) / 1e6

    def gaps(self):
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    def host_labels(self, times) -> list[str]:
        """For each of ``times``, the innermost host op open at it (host ops
        on one thread nest, so one sweep with a stack finds them all); the
        window's own label, or none, reads as "host between ops"."""
        events = sorted(self.host, key=lambda e: (e[0], -e[1]))
        order = sorted(range(len(times)), key=lambda k: times[k])
        out = [""] * len(times)
        stack, i = [], 0
        for k in order:
            t = times[k]
            while i < len(events) and events[i][0] <= t:
                while stack and stack[-1][1] <= events[i][0]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            name = stack[-1][2] if stack else WINDOW_LABEL
            out[k] = "host between ops" if name == WINDOW_LABEL else name
        return out

    def breakdown(self, labelled: "Trace | None" = None) -> dict:
        """The device's ten costliest operations by name, and the idle time
        of ``labelled`` (by default this trace) by what the host was doing
        as each gap began, ten largest."""
        by_name, by_host = {}, {}
        for a, b, name, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        labelled = self if labelled is None else labelled
        gaps = labelled.gaps()
        for (a, b), label in zip(gaps, labelled.host_labels([a for a, _ in gaps])):
            by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e6
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
        return {"device_ops": [[name[:160], s] for name, s in top(by_name)],
                "idle_gaps": [[label[:160], s] for label, s in top(by_host)]}


def _jobs(system, cell, seed, device, first_stream: int, count: int):
    """``count`` jobs, each synchronised, between two marker ops on an idle
    device: the first and the last of the device's activity.  Returns the
    seconds a job."""
    marker = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    marker.fill_(1)
    for k in range(count):
        stream = first_stream + k
        fresh = traffic.fresh(cell.cfg, cell.traffic, seed, stream, device)
        system.prove(fresh, traffic.prover_seed(seed, stream))
        torch.cuda.synchronize()
    marker.fill_(2)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / count


def _profiled(activities, what: str, run) -> list[dict]:
    """The events of ``run()`` under ``torch.profiler``."""
    t = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW_LABEL):
            per_job = run()
    fd, path = tempfile.mkstemp(prefix="zkbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    print(f"{what}: {per_job:.4f} s a job, {len(events)} events, "
          f"{time.perf_counter() - t:.3f} s in all", file=sys.stderr)
    return events


def profile(system, cell, seed, device, first_stream: int):
    """The JOBS jobs after the window, from ``first_stream`` on: (the
    device-only Trace, the labelled Trace, the WorkLog); (None, None, None)
    on a machine without a card."""
    if torch.device(device).type != "cuda":
        return None, None, None
    cuda, cpu = torch.profiler.ProfilerActivity.CUDA, torch.profiler.ProfilerActivity.CPU
    trace = Trace(_profiled([cuda], f"{PROFILED_JOBS} jobs, device activity recorded",
                            lambda: _jobs(system, cell, seed, device, first_stream, PROFILED_JOBS)),
                  PROFILED_JOBS)
    labelled = Trace(_profiled([cpu, cuda], "1 job, host operations recorded too",
                               lambda: _jobs(system, cell, seed, device,
                                             first_stream + PROFILED_JOBS, 1)),
                     1)
    peaks = roofline.Peaks.read()
    if peaks is None:
        return trace, labelled, None
    print(f"peaks: {peaks.sm_count} SMs at {peaks.clock_mhz} MHz max, power limit "
          f"{peaks.power_limit_w} W", file=sys.stderr)
    work = WorkLog(peaks)
    with work.patched():
        per_job = _jobs(system, cell, seed, device, first_stream + PROFILED_JOBS + 1, 1)
    print(f"1 job, work counted: {per_job:.4f} s", file=sys.stderr)
    return trace, labelled, work
