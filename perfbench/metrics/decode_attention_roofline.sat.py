"""decode_attention_roofline in the saturated cell."""
from perfbench.harness import layers


def read(run):
    return layers.roofline_pct(run, "decode_attention")
