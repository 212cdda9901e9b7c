"""The cells' execution time (``RunStats.exec_s``: the graphed decode
loop, ended by a device synchronize) over the decode steps, in ms."""


def read(run):
    steps = len(run.cycles) * run.mix["gen"]
    return 1e3 * sum(c.run["exec_s"] for c in run.cycles) / steps
