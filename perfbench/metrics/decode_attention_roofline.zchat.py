"""decode_attention's calls as issued in the published Zamba2 cell (head
dim 224, a full-length cache, 13 a step): their least time over the
kernel's device time in the trace, percent.
"""
from perfbench.harness import hybrid


def read(run):
    return hybrid.roofline_pct(run, "decode_attention")
