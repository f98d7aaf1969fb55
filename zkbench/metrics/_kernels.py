"""Shared by the roofline readers: device seconds of a class of kernels."""

import json
from pathlib import Path

CLASSES = json.loads((Path(__file__).parent / "kernel_classes.json").read_text())


def share(ctx, work_s: float, cls: str):
    """100 x least seconds / the class's device seconds, or None.
    ``work_s`` is counted over one job; every job asks the same work, so
    the profiled jobs ask ``trace.jobs`` times as much."""
    trace = ctx["trace"]
    if trace is None or not work_s:
        return None
    device_s = trace.kernel_seconds(CLASSES[cls])
    return 100.0 * work_s * trace.jobs / device_s if device_s > 0 else None
