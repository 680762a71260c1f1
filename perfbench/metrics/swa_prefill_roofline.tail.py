"""swa_prefill's calls as issued: their least time over the kernel's device
time in the trace, percent.
"""
from perfbench.harness import layers


def read(run):
    return layers.roofline_pct(run, "swa_prefill")
