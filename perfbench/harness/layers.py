"""Per-layer quantities from the run's spans, counts and trace.

Counts and host-clock spans cover the gangs dispatched in the window;
device times and the kernels' bounds cover the gangs of the traced
slice.  A quantity with nothing to read returns None.
"""
from __future__ import annotations

import statistics
from typing import Optional

from perfbench.counts import kernels, model, peaks
from perfbench.harness import stats

# the device functions of each hand-written kernel, as the trace names them
KERNEL_NAMES = {"swa_prefill": ("swa_prefill",),
                "decode_attention": ("decode_attention",)}


def queue_wait_p90_s(run) -> Optional[float]:
    """Due arrival to the gang's dispatch, over every request sent."""
    waits = [run.dispatch[r.index] - r.arrival if r.index in run.dispatch
             else stats.INF for r in run.reqs]
    return stats.percentile(waits, 90)


def batch_fill_pct(run) -> Optional[float]:
    gs = stats.window_gangs(run)
    if not gs:
        return None
    return 100.0 * sum(len(g.reqs) for g in gs) / sum(g.b for g in gs)


def decode_slot_waste_pct(run) -> Optional[float]:
    """Slot-steps of the decode calls whose slot had no stream left."""
    gs = [g for g in stats.window_gangs(run) if g.decode]
    if not gs:
        return None
    live = sum(run.reqs[i].decode_tokens for g in gs for i in g.reqs)
    return 100.0 * (1.0 - live / sum(g.b * len(g.decode) for g in gs))


def prefill_pad_pct(run) -> Optional[float]:
    gs = stats.window_gangs(run)
    if not gs:
        return None
    real = sum(run.reqs[i].prompt_tokens for g in gs for i in g.reqs)
    return 100.0 * (1.0 - real / sum(g.b * run.mix["bucket"] for g in gs))


def decode_step_ms(run) -> Optional[float]:
    walls = [dt for g in stats.window_gangs(run) for _, dt in g.decode]
    return 1e3 * statistics.median(walls) if walls else None


def prefill_ms_per_ktok(run) -> Optional[float]:
    gs = stats.window_gangs(run)
    if not gs:
        return None
    padded = sum(g.b * run.mix["bucket"] for g in gs)
    return 1e3 * sum(g.prefill[1] for g in gs) / (padded / 1e3)


def step_mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the useful work over the step calls' wall at the
    bf16 peak."""
    gs = stats.window_gangs(run)
    if not gs:
        return None
    m, bucket = run.conf, run.mix["bucket"]
    flops = 0.0
    for g in gs:
        for i in g.reqs:
            r = run.reqs[i]
            flops += model.prefill_useful(m, r.prompt_tokens)
            flops += sum(model.decode_useful(m, bucket + k)
                         for k in range(r.decode_tokens))
    wall = sum(g.prefill[1] + sum(dt for _, dt in g.decode) for g in gs)
    return 100.0 * flops / (wall * peaks.PEAK_FLOPS_BF16)


def _calls(run, kernel: str, g):
    """(bytes, operations, dtype) of every call of ``kernel`` gang g made."""
    m, mix = run.conf, run.mix
    bucket, dt = mix["bucket"], m["dtype"]
    n_attn = model.attention_layers(m)
    window = model.attention_window(m)
    if kernel == "swa_prefill":
        return [kernels.prefill_bound(g.b, bucket, m["num_heads"],
                                      m["num_kv_heads"], m["head_dim"],
                                      window, dt)] * n_attn
    if kernel == "decode_attention":
        s = min(bucket + mix["max_decode"] + 1, window)
        out = []
        for k in range(len(g.decode)):
            length = min(bucket + k + 1, s)
            out += [kernels.decode_bound(
                g.b, s, m["num_kv_heads"],
                m["num_heads"] // m["num_kv_heads"], m["head_dim"],
                [length] * g.b, dt)] * n_attn
        return out
    raise KeyError(kernel)


def roofline_pct(run, kernel: str) -> Optional[float]:
    """The calls' least time over the kernel's device time in the trace."""
    if run.trace is None:
        return None
    device_s = sum(s for name, s in run.trace["kernel_s"].items()
                   if any(k in name for k in KERNEL_NAMES[kernel]))
    bound = sum(peaks.bound_s(*call) for g in stats.traced_gangs(run)
                for call in _calls(run, kernel, g))
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s


def step_idle_pct(run) -> Optional[float]:
    """Share of the step calls' wall with no device operation running."""
    t = run.trace
    if t is None or t["step_wall_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["step_busy_s"] / t["step_wall_s"])
