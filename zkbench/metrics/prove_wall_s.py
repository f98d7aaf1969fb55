"""Wall seconds a prove in the traced run's window: the window's length on
the host clock (its spans synchronised) over the jobs completed in it."""


def read(ctx):
    jobs = ctx.get("jobs")
    return ctx["window_s"] / jobs if jobs else None
