"""Median over the window's commits of the program's ``put_chunks`` spans
summed in each commit (the store's puts), in ms."""
from portbench.harness import median


def read(run):
    v = median(c.spans_cell.get("put_chunks") for c in run.cycles)
    return None if v is None else 1e3 * v
