"""Median over the window's undos of ``session.checkout(prefix)``, call to
return after a device synchronize, in ms.  Per layer: an undo is host work
(SmolLM's about 25 ms, Mamba-2's full load about 400 ms, nearly all of it
CPU time), and its run medians spread too widely on the host's clock for
any allowed bound."""
from portbench.harness import median


def read(run):
    return 1e3 * median(c.undo_s for c in run.cycles)
