"""Time to first token, 90th percentile over every request sent in the
window: scheduled send (comm latency included) to the end of its gang's
prefill call, seconds; a request never served counts as infinite.
"""
from perfbench.harness import stats


def read(run):
    return stats.percentile(stats.ttfts(run), 90)
