"""Idle device seconds a prove whose gap ended with no family span of the
program's recorder open on the host: the protocol's glue in
``hyperplonk/collaborative.py`` and the prove's placeholder draws
(``_primitives.py``: the readers' jobs profiled with device activity
alone)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("zkbench_metrics_primitives",
                                               Path(__file__).parent / "_primitives.py")
_p = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_p)


def read(ctx):
    found = _p.measure(ctx)
    return None if found is None else found["idle_s"][_p.OUTSIDE]
