"""step_mfu in the saturated cell."""
from perfbench.harness import layers


def read(run):
    return layers.step_mfu_pct(run)
