"""Median over the window's cells of the seconds the graphed decode step
spent capturing in the cell (``GraphedDecodeStep.capture_s``: warm-up and
graph capture), in ms; nothing where no cell captured."""
from portbench.harness import median


def read(run):
    if not any(c.run["captures"] for c in run.cycles):
        return None
    return 1e3 * median(c.run["capture_s"] for c in run.cycles)
