"""Per-layer quantities of the published Zamba2 cells (``family``
``zamba2``), from the run's spans, counts and trace, as ``layers.py``
reads them for the attention stacks: the kernels' calls as issued over
their device time in the traced slice, and the model FLOPs of the
useful work over the step calls' wall.  A run of another family, or one
with nothing to read, gives None.
"""
from __future__ import annotations

from typing import Optional

from perfbench.counts import kernels, peaks
from perfbench.counts import zamba2 as counts
from perfbench.harness import stats

# the device functions of each kernel, as the trace names them
KERNEL_NAMES = {"ssd_scan": ("ssd_scan_kernel", "ssd_chunked_kernel"),
                "swa_prefill": ("swa_prefill",),
                "decode_attention": ("decode_attention",)}


def _ours(run) -> bool:
    return run.conf.get("family") == "zamba2"


def _calls(run, kernel: str, g):
    """(bytes, operations, dtype) of every call of ``kernel`` gang g made."""
    m, mix = run.conf, run.mix
    bucket, dt = mix["bucket"], m["dtype"]
    apps = counts.applications(m)
    if kernel == "ssd_scan":
        return ([counts.ssd_bound(m, g.b, bucket)] * m["num_layers"]
                + [counts.ssd_bound(m, g.b, 1, "float32")]
                * (m["num_layers"] * len(g.decode)))
    if kernel == "swa_prefill":
        return [kernels.prefill_bound(g.b, bucket, m["num_heads"],
                                      m["num_kv_heads"], m["head_dim"],
                                      bucket, dt)] * apps
    s = bucket + mix["max_decode"] + 1
    out = []
    for k in range(len(g.decode)):
        out += [kernels.decode_bound(
            g.b, s, m["num_kv_heads"], m["num_heads"] // m["num_kv_heads"],
            m["head_dim"], [bucket + k + 1] * g.b, dt)] * apps
    return out


def roofline_pct(run, kernel: str) -> Optional[float]:
    """The calls' least time over the kernel's device time in the trace."""
    if not _ours(run) or run.trace is None:
        return None
    device_s = sum(s for name, s in run.trace["kernel_s"].items()
                   if any(k in name for k in KERNEL_NAMES[kernel]))
    bound = sum(peaks.bound_s(*call) for g in stats.traced_gangs(run)
                for call in _calls(run, kernel, g))
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s


def step_mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the useful work over the step calls' wall at the
    bf16 peak."""
    gs = stats.window_gangs(run)
    if not _ours(run) or not gs:
        return None
    m, bucket = run.conf, run.mix["bucket"]
    flops = 0.0
    for g in gs:
        for i in g.reqs:
            r = run.reqs[i]
            flops += counts.prefill_useful(m, r.prompt_tokens)
            flops += sum(counts.decode_useful(m, bucket + k)
                         for k in range(r.decode_tokens))
    wall = sum(g.prefill[1] + sum(dt for _, dt in g.decode) for g in gs)
    return 100.0 * flops / (wall * peaks.PEAK_FLOPS_BF16)
