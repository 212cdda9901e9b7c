"""Median over the window's undos of the program's ``stage_h2d`` spans
summed in each undo (a full load's pinned staging, the copies into it and
the upload's enqueue), in ms; nothing where no undo loaded a leaf in
full."""
from portbench.harness import median


def read(run):
    v = median(c.spans_undo.get("stage_h2d") for c in run.cycles)
    return None if v is None else 1e3 * v
