"""decode_attention's calls as issued (cache lengths as given): their least
time over the kernel's device time in the trace, percent.
"""
from perfbench.harness import layers


def read(run):
    return layers.roofline_pct(run, "decode_attention")
