"""ssd_scan's calls as issued in the published Zamba2 cell, both bodies
(the chunked prefill at T = the bucket, the decode recurrence at T = 1),
81 a step: their least time over the kernel's device time in the trace,
percent.
"""
from perfbench.harness import hybrid


def read(run):
    return hybrid.roofline_pct(run, "ssd_scan")
