"""Median over the window's commits of the program's ``detect`` span
(delta detection: hashing, the fused device pack), in ms."""
from portbench.harness import median


def read(run):
    v = median(c.spans_cell.get("detect") for c in run.cycles)
    return None if v is None else 1e3 * v
