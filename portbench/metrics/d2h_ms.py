"""Median over the window's commits of the program's ``d2h`` spans summed
in each commit (a leaf's bytes off the card into a host buffer: the full
serialize's copy, the fused pack's reads, the dirty-range reads), in ms."""
from portbench.harness import median


def read(run):
    v = median(c.spans_cell.get("d2h") for c in run.cycles)
    return None if v is None else 1e3 * v
