"""The whole undo's share of the chip's peak: the undo's least time (as
``checkout_kernel_roofline``) over the median undo's host seconds, in
%."""
from portbench import arith
from portbench.harness import median


def read(run):
    mix = run.mix
    least = arith.least_seconds(arith.undo_least_bytes(
        run.model, mix["batch"], mix["prompt"], mix["gen"], run.chunk_bytes))
    return 100.0 * least / median(c.undo_s for c in run.cycles)
