"""Median wall of a decode step call (the call until the device finished),
milliseconds.
"""
from perfbench.harness import layers


def read(run):
    return layers.decode_step_ms(run)
