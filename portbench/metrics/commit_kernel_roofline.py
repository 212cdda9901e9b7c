"""The commit's least time (``arith.commit_least_bytes`` at the HBM peak:
every byte the cell wrote read once, the dirty chunks written once) over
the device time of the operations in the traced commits outside the
cell's body, in %."""
from portbench import arith


def read(run):
    d = run.device
    if not d or d["commit_device_s"] <= 0:
        return None
    mix = run.mix
    least = arith.least_seconds(arith.commit_least_bytes(
        run.model, mix["batch"], mix["prompt"], mix["gen"], run.chunk_bytes))
    return 100.0 * least * d["n_commits"] / d["commit_device_s"]
