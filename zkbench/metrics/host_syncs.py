"""Times a prove makes the host wait for the card: the sum of the program's
``sync.*`` counters (``utils/timer.py``) over the readers' measured jobs,
a job (``_primitives.py``)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("zkbench_metrics_primitives",
                                               Path(__file__).parent / "_primitives.py")
_p = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_p)


def read(ctx):
    found = _p.measure(ctx)
    return None if found is None else found["host_syncs"]
