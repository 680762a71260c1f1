"""Share of the step calls' wall in the trace with no device operation
running, percent.
"""
from perfbench.harness import layers


def read(run):
    return layers.step_idle_pct(run)
