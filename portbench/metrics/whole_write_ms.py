"""Median over the window's commits of the program's ``write_whole``
spans summed in each commit (each co-variable written whole, through the
pinned ring or serialized first), in ms; nothing where no commit has the
span."""
from portbench.harness import median


def read(run):
    v = median(c.spans_cell.get("write_whole") for c in run.cycles)
    return None if v is None else 1e3 * v
