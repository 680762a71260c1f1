"""One run of a cell end to end: serve, read the metrics, check, report."""
from __future__ import annotations

import math
from typing import List, Tuple

from perfbench.harness import check, serve, spec


def device_info(run, peak: int, device) -> dict:
    import torch
    on_card = str(device).startswith("cuda")
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def read_metrics(bench: dict, run, trace: bool, root=spec.ROOT) -> dict:
    """Every metric the run reports, each by its own reader; a reader that
    finds nothing to read returns None and the metric is left out, as is
    a tail that reached a request never served (infinite: the run is not
    correct then)."""
    out = {}
    for m in spec.cell_metrics(bench, run.cell, trace):
        value = spec.metric_reader(m["name"], root)(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda",
        root=spec.ROOT) -> Tuple[dict, List[str]]:
    conf = spec.load_config(bench, cell["config"], root)
    mix = spec.load_mix(cell["traffic"], root)
    limits = spec.cell_limits(cell["name"], root)
    family = spec.reference(conf["family"], root)
    r, tree, generated, peak = serve.serve(cell["name"], conf, mix, family,
                                           seed, seconds, trace, t_start,
                                           device)
    metrics = read_metrics(bench, r, trace, root)
    pick = check.sample(r, generated, seed)
    got = check.gaps(family, tree, conf, mix["bucket"], r, generated, pick,
                     device)
    ok, numbers = check.verdict(r, generated, got["served"], limits)
    result = {"correct": ok, "attempted": len(r.reqs),
              "failed": numbers["unfinished"]["value"],
              "metrics": metrics, "device": device_info(r, peak, device)}
    if r.trace is not None:
        result["breakdown"] = {"device_ops": r.trace["device_ops"],
                               "idle_gaps": r.trace["idle_gaps"]}
    late = sorted(r.lateness)
    result["generator"] = {
        "sent": len(r.reqs), "gangs": len(r.gangs),
        "late_p50_s": late[len(late) // 2] if late else None,
        "late_max_s": late[-1] if late else None}
    if r.trace is not None:
        result["generator"].update(trace_start_s=r.trace["start_s"],
                                   trace_collect_s=r.trace["collect_s"],
                                   trace_read_s=r.trace["read_s"],
                                   trace_operations=r.trace["operations"])
    result["check"] = numbers
    lines = [f"check {k}: {v['value']} (limit {v['limit']})"
             for k, v in numbers.items()]
    return result, lines
