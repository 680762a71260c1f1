"""Model FLOPs of the useful work (real prompt tokens, live decode slots)
over the step calls' wall at the 989 TFLOP/s bf16 peak, percent.
"""
from perfbench.harness import layers


def read(run):
    return layers.step_mfu_pct(run)
