"""Party 0's bytes sent plus received a job, in 10^6 bytes, from the
program's party-network counters (mean over the window's jobs; the
counters are exact and the same for every job)."""


def read(ctx):
    comm = ctx.get("comm") or []
    if not comm:
        return None
    return sum(up + down for up, down, _ in comm) / len(comm) / 1e6
