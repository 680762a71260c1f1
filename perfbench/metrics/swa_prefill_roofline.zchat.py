"""swa_prefill's calls as issued in the published Zamba2 cell (head dim
224, full causal, 13 a prefill): their least time over the kernel's
device time in the trace, percent.
"""
from perfbench.harness import hybrid


def read(run):
    return hybrid.roofline_pct(run, "swa_prefill")
