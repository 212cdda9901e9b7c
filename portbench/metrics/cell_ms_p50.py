"""Median over the window's cells of ``session.run("generate")``, call to
return after a device synchronize: the execution and Kishu's commit."""
from portbench.harness import median


def read(run):
    return 1e3 * median(c.cell_s for c in run.cycles)
