"""Output tokens (first and streamed) whose wall time fell in the window,
over the window's seconds.
"""
from perfbench.harness import stats


def read(run):
    return stats.tokens_in_window(run) / run.seconds
