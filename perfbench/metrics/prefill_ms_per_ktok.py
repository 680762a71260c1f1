"""Prefill call wall per thousand padded prompt tokens, milliseconds."""
from perfbench.harness import layers


def read(run):
    return layers.prefill_ms_per_ktok(run)
