"""Seconds a job spends in the program's ``Commit`` and ``Open`` spans,
the device synchronised at their edges, mean over the traced window's
jobs."""


def read(ctx):
    return ctx["spans"].get("commit_open") or None
