"""swa_prefill_roofline in the saturated cell."""
from perfbench.harness import layers


def read(run):
    return layers.roofline_pct(run, "swa_prefill")
