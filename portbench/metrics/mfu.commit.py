"""The whole commit's share of the chip's peak: the commit's least time
(as ``commit_kernel_roofline``) over the median commit's host seconds
(``RunStats.total_s - exec_s``: detection, write, publish), in %."""
from portbench import arith
from portbench.harness import median


def read(run):
    mix = run.mix
    least = arith.least_seconds(arith.commit_least_bytes(
        run.model, mix["batch"], mix["prompt"], mix["gen"], run.chunk_bytes))
    return 100.0 * least / median(c.run["total_s"] - c.run["exec_s"]
                                  for c in run.cycles)
