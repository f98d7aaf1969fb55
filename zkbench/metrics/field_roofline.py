"""The elementwise field kernels' share of their roofline in the profiled
jobs: the least time of the products, sums and differences asked of
``Field`` (``zkbench/roofline.py``) over the device time of the kernels of
``csrc/fr.cu``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("zkbench_metrics_kernels",
                                               Path(__file__).parent / "_kernels.py")
_k = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k)


def read(ctx):
    work = ctx["work"]
    return None if work is None else _k.share(ctx, work.field_s, "field")
