"""Tokens generated in the window over the window's host seconds (the
window ends when the last cycle it started ends)."""


def read(run):
    return run.tokens / run.window_s
