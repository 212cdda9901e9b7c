"""Median over the window's commits of the program's ``chunk_keys`` spans
summed in each commit (keying the chunks to write on the pool), in ms."""
from portbench.harness import median


def read(run):
    v = median(c.spans_cell.get("chunk_keys") for c in run.cycles)
    return None if v is None else 1e3 * v
