"""ttft_p90_s in the saturated cell, where it swings with the queue and is
recorded, not judged.
"""
from perfbench.harness import stats


def read(run):
    return stats.percentile(stats.ttfts(run), 90)
