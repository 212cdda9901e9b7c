"""Median over the window's undos that patched a co-variable in place of
the program's ``patch`` span (``patch_scatter`` and its uploads), in ms;
nothing where no undo patched."""
from portbench.harness import median


def read(run):
    v = median(c.spans_undo.get("patch") for c in run.cycles
               if c.checkout["covs_patched"] > 0)
    return None if v is None else 1e3 * v
