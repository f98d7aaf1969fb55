"""The port's recorder of spans and counters, and the reference's
start_timer!/end_timer! (``trace``).

``trace`` mirrors the JAX package's ``utils/timer.py``: indented
Start:/End: lines with durations for the protocol's steps.  The times are
host times: work still queued on the card when a span closes is not in
it, unless a ``sync`` function is set (for example
``torch.cuda.synchronize``), which every ``trace`` span then calls as it
opens and closes.

The recorder is off by default.  Off, a span costs one flag check and a
bare ``yield`` (a ``spanned`` function one flag check), a counter one flag
check: no clock is read, nothing is kept and no
``torch.profiler.record_function`` is entered.  The one exception is a
``trace`` span while a profiler runs: it still enters its
``record_function``, so that a profile names the protocol's steps, and
keeps nothing.  ``enable()`` switches the recorder on, and so does a
timed window (``set_sync``): spans are synchronised only to be timed.
On, each span is kept as a ``Span`` and enters a ``record_function`` of
its name; counters add up per job.  The records stay in memory until
``clear()``.

* A span's times are ``time.time_ns()``: the clock of ``torch.profiler``'s
  host and device events, so a profile's events and the spans read on one
  axis.
* A job is one prove: each prover opens it (``span(..., job=True)``) and
  every span and count inside it carries its id.
* A span's ``family`` names the protocol-primitive layer it times
  (``FAMILIES``); work is the innermost family span's.  A span's self time
  is its duration less what its child spans cover (``self_ns``).
* Counters named ``sync.<site>`` count the places a prove makes the host
  wait for the card (a read of a device value, a blocking upload of a host
  array), one a pass, on every device.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import sys
import time
from typing import NamedTuple

import torch

FAMILIES = ("msm", "sumcheck", "pcs", "acc_product", "pss")
"""The protocol-primitive layers: the MSMs; the sumchecks; the commitments
and opens outside their MSMs; the grand products; share conversions and
the exchange of shares."""


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None
    job: int | None
    family: str | None
    start_ns: int
    end_ns: int


_ENABLED = False  # enable()
_SHOW = False  # trace() prints its Start:/End: lines
_SYNC = None
_WINDOW = False  # a timed window is open (set_sync)
_ON = False  # the recorder's switch: enabled, or a timed window open
_INDENT = 0
_SPANS: list[Span] = []
_COUNTS: dict[tuple[int | None, str], int] = {}
_OPEN: list[tuple[int, int | None]] = []  # (id, job) of the open spans, innermost last
_IDS = itertools.count(1)
_JOBS = itertools.count(1)


def _switch():
    global _ON
    _ON = _ENABLED or _WINDOW


def enable(on: bool = True, show: bool = True):
    """Switch the recorder on or off; on with ``show``, ``trace`` spans also
    print their Start:/End: lines."""
    global _ENABLED, _SHOW
    _ENABLED, _SHOW = on, on and show
    _switch()


def set_sync(fn=None):
    """Open a timed window: call ``fn`` at each ``trace`` span's start and
    end, so that those spans time the device's work and not only its
    enqueueing; the recorder is on while the window is open.  A call while
    a window is open replaces its function, or, with None, closes it.

    ``set_sync(None)`` is a toggle: with no window open it opens one that
    syncs nothing (a window on the CPU, where no device queue needs waiting
    for).  So a call with None is no reset: made once with no window open,
    it leaves the recorder on, keeping records until ``clear()``.  Close a
    window with None exactly once."""
    global _SYNC, _WINDOW
    _WINDOW = fn is not None or not _WINDOW
    _SYNC = fn if _WINDOW else None
    _switch()


def _begin(job: bool):
    """Open a span: (id, parent id, job id)."""
    parent, cur = _OPEN[-1] if _OPEN else (None, None)
    sid = next(_IDS)
    if job and cur is None:
        cur = next(_JOBS)
    _OPEN.append((sid, cur))
    return sid, parent, cur


def _end(name: str, family, opened, start: int, end: int) -> int:
    """Close the innermost span; its duration in ns."""
    _OPEN.pop()
    _SPANS.append(Span(name, *opened, family, start, end))
    return end - start


@contextlib.contextmanager
def span(name: str, family: str | None = None, job: bool = False):
    """``with span("c_commit", "pcs"):`` -- a recorded span, never
    synchronised; ``job``: the span opens a job unless one is open."""
    if not _ON:
        yield
        return
    opened = _begin(job)
    try:
        with torch.profiler.record_function(name):
            start = time.time_ns()
            try:
                yield
            finally:
                end = time.time_ns()
    finally:
        _end(name, family, opened, start, end)


def spanned(family: str | None = None, job: bool = False):
    """Decorator: each call of the function is a span of its name (``job``:
    a prover's entry, which opens a job)."""
    def wrap(fn):
        name = fn.__name__

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with span(name, family, job):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, k: int = 1):
    """Add ``k`` to the counter ``name`` of the job open now."""
    if _ON:
        key = (_OPEN[-1][1] if _OPEN else None, name)
        _COUNTS[key] = _COUNTS.get(key, 0) + k


_profiling = torch._C._autograd._profiler_enabled
"""Whether a ``torch.profiler`` profile is recording."""


@contextlib.contextmanager
def trace(label: str, enabled: bool = True):
    """``with trace("Commit"):`` -- a protocol step: a span, printed while
    the recorder is enabled (and ``enabled``), synchronised at both edges
    while a sync function is set; with the recorder off, only an
    annotation of a running profile."""
    global _INDENT
    if not _ON:
        if _profiling():
            with torch.profiler.record_function(label.replace(" ", "_")):
                yield
        else:
            yield
        return
    show = _SHOW and enabled
    if show:
        print("  " * _INDENT + f"Start: {label}", flush=True, file=sys.stderr)
        _INDENT += 1
    if _SYNC is not None:
        _SYNC()
    opened = _begin(False)
    try:
        with torch.profiler.record_function(label.replace(" ", "_")):
            start = time.time_ns()
            try:
                yield
                if _SYNC is not None:
                    _SYNC()
            finally:
                end = time.time_ns()
    finally:
        dt = _end(label, None, opened, start, end)
        if show:
            _INDENT -= 1
            print("  " * _INDENT + f"End:   {label} {dt / 1e6:.3f}ms", flush=True,
                  file=sys.stderr)


def records() -> list[tuple[str, float]]:
    """(name, seconds) of each span closed since the last ``clear``, in the
    order they closed."""
    return [(s.name, (s.end_ns - s.start_ns) / 1e9) for s in _SPANS]


def spans() -> list[Span]:
    """The spans closed since the last ``clear``, in the order they closed."""
    return list(_SPANS)


def counters() -> dict:
    """{job id (None outside a job): {counter: count}} since the last
    ``clear``."""
    out: dict = {}
    for (job, name), k in _COUNTS.items():
        out.setdefault(job, {})[name] = k
    return out


def clear():
    """Drop every record kept."""
    _SPANS.clear()
    _COUNTS.clear()


def self_ns(spans_) -> dict[int, int]:
    """{span id: its duration less what its child spans among ``spans_``
    cover}."""
    out = {s.id: s.end_ns - s.start_ns for s in spans_}
    for s in spans_:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
