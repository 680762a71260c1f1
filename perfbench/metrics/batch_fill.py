"""Requests per gang over the gang's bucket b, summed over the gangs
dispatched in the window, percent.
"""
from perfbench.harness import layers


def read(run):
    return layers.batch_fill_pct(run)
