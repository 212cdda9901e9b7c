"""Median over the window's undos of the program's ``fetch`` plus
``materialize`` spans (chunk reads and full loads), in ms."""
from portbench.harness import median


def read(run):
    v = median(c.spans_undo["fetch"] + c.spans_undo["materialize"]
               for c in run.cycles if "fetch" in c.spans_undo
               and "materialize" in c.spans_undo)
    return None if v is None else 1e3 * v
