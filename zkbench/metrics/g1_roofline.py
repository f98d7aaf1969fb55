"""The G1 kernels' share of their roofline in the profiled jobs: the least
time of the point work the prove asks of ``Curve`` and the MSMs
(``zkbench/roofline.py``) over the device time of the kernels of
``csrc/g1.cu`` and ``csrc/g1_chain.cu``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("zkbench_metrics_kernels",
                                               Path(__file__).parent / "_kernels.py")
_k = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k)


def read(ctx):
    work = ctx["work"]
    return None if work is None else _k.share(ctx, work.g1_s, "g1")
