"""1 - the union of the device operations' intervals over the traced
window (``torch.profiler``, the traced cycles), in %."""


def read(run):
    d = run.device
    if not d or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
