"""Hierarchical wall-clock tracing -- the reference's start_timer!/end_timer!.

Mirrors the JAX package's ``utils/timer.py``: indented Start:/End: lines
with durations, gated by a process-wide enable flag, and each span wrapped
in ``torch.profiler.record_function`` so it shows in profiler traces.
The times are host times: work still queued on the card when a span
closes is not in it, unless a ``sync`` function is set (for example
``torch.cuda.synchronize``), which every span then calls as it opens and
closes.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

_ENABLED = False
_INDENT = 0
_RECORDS: list[tuple[str, float]] = []
_SYNC = None


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def set_sync(fn=None):
    """Call ``fn`` (or nothing, with None) at each span's start and end, so
    that spans time the device's work and not only its enqueueing."""
    global _SYNC
    _SYNC = fn


def records():
    """List of (label, seconds) for all closed spans since last clear."""
    return list(_RECORDS)


def clear():
    _RECORDS.clear()


@contextlib.contextmanager
def trace(label: str, enabled: bool = True):
    """``with trace("Commit"):`` -- timed, indented, profiler-annotated."""
    global _INDENT
    show = _ENABLED and enabled
    if show:
        print("  " * _INDENT + f"Start: {label}", flush=True, file=sys.stderr)
        _INDENT += 1
    if _SYNC is not None:
        _SYNC()
    t0 = time.perf_counter()
    with torch.profiler.record_function(label.replace(" ", "_")):
        yield
    if _SYNC is not None:
        _SYNC()
    dt = time.perf_counter() - t0
    _RECORDS.append((label, dt))
    if show:
        _INDENT -= 1
        print("  " * _INDENT + f"End:   {label} {dt*1e3:.3f}ms", flush=True, file=sys.stderr)
