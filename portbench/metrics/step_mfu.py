"""Model FLOPs of the window's tokens (``arith.generate_flops``: the
projections, attention over the filled context or the SSM update, the
unembedding) over the window's seconds times the H100's bf16 dense
peak, in %."""
from portbench import arith


def read(run):
    mix = run.mix
    flops = len(run.cycles) * arith.generate_flops(
        run.model, mix["batch"], mix["prompt"], mix["gen"])
    return 100.0 * flops / (run.window_s * arith.PEAK_BF16_FLOPS)
