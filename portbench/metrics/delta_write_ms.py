"""Median over the window's commits of the program's ``write_delta``
spans summed in each commit (the dirty-range attempt of each co-variable,
taken or declined), in ms; nothing where no commit has the span."""
from portbench.harness import median


def read(run):
    v = median(c.spans_cell.get("write_delta") for c in run.cycles)
    return None if v is None else 1e3 * v
