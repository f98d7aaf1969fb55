"""CUDA kernels a job launches: every kernel in the profiled jobs' trace,
per job (the host's dispatch load)."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace.jobs:
        return None
    count = len(trace.kernels())
    return count / trace.jobs if count else None
