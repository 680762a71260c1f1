"""Share of the requests sent in the window whose first token met send +
TTFT SLO and whose every gap between tokens met the TBT SLO, percent; a
request never served misses.
"""
from perfbench.harness import stats


def read(run):
    return stats.attainment_pct(run)
