"""Prefill tokens that are padding (to the bucket's length and the bucket's
b), percent.
"""
from perfbench.harness import layers


def read(run):
    return layers.prefill_pad_pct(run)
