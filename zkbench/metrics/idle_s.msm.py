"""Idle device seconds a prove whose gap ended while an ``msm`` span of the
program's recorder was the innermost family span open on the host: the
gap ends when the host launches the next op (``_primitives.py``: the
readers' jobs profiled with device activity alone)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("zkbench_metrics_primitives",
                                               Path(__file__).parent / "_primitives.py")
_p = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_p)


def read(ctx):
    found = _p.measure(ctx)
    return None if found is None else found["idle_s"]["msm"]
