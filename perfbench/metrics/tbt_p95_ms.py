"""Gap between consecutive tokens of a request, 95th percentile over every
gap whose later token came in the window, milliseconds.
"""
from perfbench.harness import stats


def read(run):
    p95 = stats.percentile(stats.gaps_in_window(run), 95)
    return None if p95 is None else 1e3 * p95
