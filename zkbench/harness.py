"""One run of one cell: set-up, a measured window of jobs served back to
back, the check of a sampled job against the plain reference, and the
result's last line.

``run`` takes the device as an argument so that the CPU tests can drive
it at a tiny size; ``zkbench.run`` (the benchmark's command) always passes
the card and fails without one.
"""

from __future__ import annotations

import gc
import json
import random
import resource
import sys
import time
from pathlib import Path

import torch

from . import manifest, tracing, traffic
from .compare import bundle_mismatches
from .reference import g1

FORBIDDEN = ("jax", "jaxlib", "flax", "scalable_collaborative_zksnark_tpu")
"""Top-level module names that may not be loaded in a run's process."""
CACHE = ".zkbench_cache"
"""The benchmark's caches (the SRS file), at this fixed path inside the
checkout: only a checkout's first run builds them."""


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose whole top-level name (before the first
    dot) is in FORBIDDEN; the port's own name only begins with one."""
    names = sys.modules if names is None else names
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


class Outcome(Exception):
    """A run that ends without a result line: ``code`` and why."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(a) for a in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(a) for a in x)
    return x


class Cell:
    """The parts of one cell that a run and the control share."""

    def __init__(self, root, name: str):
        self.man = manifest.Manifest(root)
        self.name = name
        self.entry = self.man.workload(name)
        self.cfg = self.man.config(self.entry["config"])
        self.traffic = self.man.traffic(self.entry["traffic"])
        self.adapter = manifest.adapter(self.cfg["adapter"])
        self.reference = manifest.reference(self.cfg["reference"])


def _host():
    """(CPU seconds of this process, its involuntary context switches)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_nivcsw


def _window(system, cell, seed, device, seconds, first_stream):
    """Jobs back to back until ``seconds`` have passed: (jobs [(stream,
    bundle, comm)], failures, attempted, start, end).  No job waits for
    the device before the next starts; the window closes when the last
    job started has ended on the device, and ``end`` is read after that."""
    jobs, failed, attempted, ends = [], 0, 0, []
    collections = []  # (job, seconds) of each of the interpreter's full collections
    began = [0.0]

    def gc_clock(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        elif info["generation"] == 2:
            collections.append((len(ends), time.perf_counter() - began[0]))

    gc.callbacks.append(gc_clock)
    host0 = _host()
    start = time.perf_counter()
    end = start
    stream = first_stream
    while end - start < seconds:
        attempted += 1
        try:
            fresh = traffic.fresh(cell.cfg, cell.traffic, seed, stream, device)
            bundle, comm = system.prove(fresh, traffic.prover_seed(seed, stream))
            jobs.append((stream, bundle, comm))
        except (RuntimeError, ValueError) as exc:
            failed += 1
            print(f"job {stream} raised {type(exc).__name__}: {exc}", file=sys.stderr)
            if failed > 3:
                raise
        end = time.perf_counter()
        ends.append(end)
        stream += 1
    _sync(device)
    end = ends[-1] = time.perf_counter()
    host1 = _host()
    gc.callbacks.remove(gc_clock)
    print(f"host over the window: {host1[0] - host0[0]:.3f} CPU s of {end - start:.3f} s, "
          f"{host1[1] - host0[1]} involuntary switches", file=sys.stderr)
    times = [b - a for a, b in zip([start] + ends[:-1], ends)]
    print("job seconds: " + " ".join(f"{t:.4f}" for t in times), file=sys.stderr)
    print("full collections (job, seconds): "
          + " ".join(f"{j} {t:.4f}" for j, t in collections), file=sys.stderr)
    return jobs, failed, attempted, start, end


def _check(cell, sample, comms, seed, device, table):
    """Compare the sampled job (stream, bundle) with the reference, and
    every job's counters with the reference's: (numbers compared, jobs
    failed)."""
    stream, bundle = sample
    tables = {**traffic.static(cell.cfg, cell.traffic, seed, device),
              **traffic.fresh(cell.cfg, cell.traffic, seed, stream, device)}
    want, want_comm = cell.reference.prove(cell.cfg, cell.traffic, tables,
                                           traffic.prover_seed(seed, stream), device)
    del tables
    bad, total = bundle_mismatches(bundle, want, table)
    comm_bad = [s for s, c in comms if tuple(c) != tuple(want_comm)]
    failed = len(set(comm_bad) | ({stream} if bad else set()))
    print(f"job {stream} checked: {total} elements of its bundle, the counters of "
          f"{len(comms)} jobs", file=sys.stderr)
    compared = {"bundle_mismatches": {"value": bad, "limit": 0},
                "comm_mismatches": {"value": len(comm_bad), "limit": 0}}
    return compared, failed


def run(root, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        started: float | None = None) -> dict:
    """One run; returns the result line's object.  ``started``: the
    process's start on the host clock (set-up is timed from it)."""
    started = time.perf_counter() if started is None else started
    cell = Cell(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # set-up: the system, the run's fixed tables, one warm-up job
    static = traffic.static(cell.cfg, cell.traffic, seed, device)
    system = cell.adapter.System(cell.cfg, cell.traffic, static, device, Path(root) / CACHE)
    fresh = traffic.fresh(cell.cfg, cell.traffic, seed, traffic.WARMUP, device)
    system.prove(fresh, traffic.prover_seed(seed, traffic.WARMUP))
    del fresh
    _sync(device)
    setup_s = time.perf_counter() - started
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    ctx = {"cell": cell, "spans": [], "trace": None, "labelled": None, "work": None}
    if trace:
        jobs, failed, attempted, start, end, ctx["spans"] = tracing.span_window(
            system, cell, seed, device, seconds, _window)
        ctx["trace"], ctx["labelled"], ctx["work"] = tracing.profile(
            system, cell, seed, device, traffic.WINDOW + attempted)
        attempted += tracing.JOBS
    else:
        jobs, failed, attempted, start, end, busy = tracing.device_window(
            system, cell, seed, device, seconds, _window)
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if not jobs:
        raise Outcome(4, "no job completed in the window")
    ctx["comm"] = [c for _, _, c in jobs]
    ctx["jobs"] = len(jobs)
    ctx["window_s"] = end - start
    stream, bundle, _ = jobs[random.Random(seed).randrange(len(jobs))]
    sample = (stream, _to_cpu(bundle))
    comms = [(s, c) for s, _, c in jobs]

    # free the program's state before the reference runs
    system.close()
    del system, static, jobs, bundle
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    print(f"set-up {setup_s:.3f} s, window {end - start:.3f} s, {len(comms)} jobs",
          file=sys.stderr)
    t = time.perf_counter()
    compared, bad_jobs = _check(cell, sample, comms, seed, device, g1.GeneratorTable())
    failed += bad_jobs
    print(f"reference check {time.perf_counter() - t:.3f} s", file=sys.stderr)

    found = forbidden_modules()
    if found:
        raise Outcome(3, f"modules of JAX or of the JAX package were loaded: {found}")

    if trace:
        metrics = {}
        for m in cell.man.per_layer(workload):
            value = cell.man.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"prove_device_s": None if busy is None else busy / len(comms),
                  "setup_s": setup_s, "peak_mem_GB": window_peak / 1e9}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.man.end_to_end(workload) if values.get(m["name"]) is not None}
    result = {
        "correct": failed == 0 and all(v["value"] <= v["limit"] for v in compared.values()),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(dev, cell.entry["chips"], max(setup_peak, window_peak)),
    }
    if trace and ctx["trace"] is not None:
        result["device"]["busy_s"] = ctx["trace"].busy_s
        result["device"]["window_s"] = ctx["trace"].window_s
        result["breakdown"] = ctx["trace"].breakdown(ctx["labelled"])
    result["compared"] = compared
    return result


def device_info(dev, count: int, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(peak)}


def emit(result: dict):
    """The compared numbers on standard error, then the result line."""
    for name, v in result["compared"].items():
        print(f"compared {name} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
