"""Slot-steps of decode calls whose slot had no stream left (a gang runs to
its longest stream), percent.
"""
from perfbench.harness import layers


def read(run):
    return layers.decode_slot_waste_pct(run)
