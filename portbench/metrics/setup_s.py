"""Process start to the window's start: imports, kernel builds and loads,
weights, the prefix fill and commit, graph capture and the warm cycles."""


def read(run):
    return run.setup_s
