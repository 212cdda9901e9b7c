"""Mean over the window's commits of ``WriteStats.bytes_dev2host``, the
bytes the fused device pack moved from the card to the host, in MB;
nothing where no commit went through the pack (a state rewritten whole
is copied out by the full serialize, which this counter does not see)."""


def read(run):
    total = sum(c.run["bytes_dev2host"] for c in run.cycles)
    return total / len(run.cycles) / 1e6 if total else None
