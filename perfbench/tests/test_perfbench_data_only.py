"""A configuration, a traffic mix and a per-layer metric are added by
adding files and entries: the harness finds them by name, and no file it
had is edited."""
import hashlib
import json
import time

import perfbench_tiny
from perfbench.harness import measure, spec

READER = '''"""Requests per gang over the window."""


def read(run):
    gangs = [g for g in run.gangs if run.in_window(g)]
    return sum(len(g.reqs) for g in gangs) / len(gangs) if gangs else None
'''


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_added_by_data_alone(tmp_path):
    root = perfbench_tiny.make_root(tmp_path)
    before = _digests(root / "perfbench")
    pb = root / "perfbench"
    conf = dict(perfbench_tiny.TINY["h2o-danube-1.8b"], num_layers=3,
                source="a deeper cut of the same stack")
    (pb / "configs" / "danube-3layer.json").write_text(json.dumps(conf))
    (pb / "traffic" / "tiny-faster.json").write_text(
        json.dumps({"extends": "tiny", "rate_rps": 16.0}))
    (pb / "metrics" / "requests_per_gang.py").write_text(READER)
    (pb / "cells" / "danube3-tiny.json").write_text(
        json.dumps({"logit_gap": 1e-3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "danube-3layer", "source": "x",
                             "file": "perfbench/configs/danube-3layer.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "danube3-tiny",
                               "config": "danube-3layer",
                               "traffic": "tiny-faster", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "requests_per_gang", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scaler and solver",
                               "moves": "tokens_per_s",
                               "workloads": ["danube3-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(pb)
    assert all(after[p] == d for p, d in before.items())

    bench = spec.load_benchmark(root)
    cell = spec.find(bench["workloads"], "danube3-tiny", "workload")
    result, _ = measure.run(bench, cell, 11, 1.0, True, time.perf_counter(),
                            device="cpu", root=root)
    assert result["correct"]
    assert result["attempted"] == 16
    assert result["metrics"]["requests_per_gang"]["value"] >= 1.0
    assert "batch_fill" in result["metrics"]
    end, _ = measure.run(bench, cell, 11, 1.0, False, time.perf_counter(),
                         device="cpu", root=root)
    assert set(end["metrics"]) == {"tbt_p95_ms", "tokens_per_s", "setup_s"}
