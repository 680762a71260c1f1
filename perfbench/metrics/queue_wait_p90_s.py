"""Due arrival to the dispatch of the request's gang on the wall clock,
90th percentile over every request sent, seconds.
"""
from perfbench.harness import layers


def read(run):
    return layers.queue_wait_p90_s(run)
