"""The undo's least time (``arith.undo_least_bytes`` at the HBM peak: the
chunks the cell dirtied, read once and written once) over the device
time of the operations in the traced undos, in %."""
from portbench import arith


def read(run):
    d = run.device
    if not d or d["undo_device_s"] <= 0:
        return None
    mix = run.mix
    least = arith.least_seconds(arith.undo_least_bytes(
        run.model, mix["batch"], mix["prompt"], mix["gen"], run.chunk_bytes))
    return 100.0 * least * d["n_undos"] / d["undo_device_s"]
