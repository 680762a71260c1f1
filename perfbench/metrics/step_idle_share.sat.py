"""step_idle_share in the saturated cell."""
from perfbench.harness import layers


def read(run):
    return layers.step_idle_pct(run)
