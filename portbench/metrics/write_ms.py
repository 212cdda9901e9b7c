"""Median over the window's commits of ``RunStats.write_s`` (serialize,
chunk puts, the flush), in ms."""
from portbench.harness import median


def read(run):
    return 1e3 * median(c.run["write_s"] for c in run.cycles)
