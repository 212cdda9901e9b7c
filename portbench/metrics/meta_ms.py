"""Median over the window's commits of the commit's metadata: the
program's ``meta_docs`` span (building the commit, refcount and HEAD
documents) plus its ``publish`` span (the store's metadata batch), in
ms; nothing where no commit built its documents under a span."""
from portbench.harness import median


def read(run):
    v = median(c.spans_cell["meta_docs"] + c.spans_cell.get("publish", 0.0)
               for c in run.cycles if "meta_docs" in c.spans_cell)
    return None if v is None else 1e3 * v
