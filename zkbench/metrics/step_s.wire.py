"""Seconds a job spends in the program's ``Wire identity`` span, the
device synchronised at its edges, mean over the traced window's jobs."""


def read(ctx):
    return ctx["spans"].get("wire") or None
