"""Device seconds a prove of the kernels, copies and memsets launched while
an ``sumcheck`` span of the program's recorder is the innermost family span
open (``_primitives.py``: the readers' labelled job, each op joined to its
launch by kineto's correlation id)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("zkbench_metrics_primitives",
                                               Path(__file__).parent / "_primitives.py")
_p = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_p)


def read(ctx):
    found = _p.measure(ctx)
    return None if found is None else found["device_s"]["sumcheck"]
