"""A tiny copy of the benchmark for CPU tests: the real harness, metric
readers and references under a temporary root, with the port's reduced
cut of the configuration and a short mix."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.harness import spec

REPO = spec.ROOT

# the port's -reduced cut, as a configuration file
TINY = {
    "h2o-danube-1.8b": {
        "registry_id": "h2o-danube-1.8b", "family": "danube",
        "block": "swa+mlp", "num_layers": 2, "d_model": 64, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
        "window_size": 16, "rope_theta": 10000.0, "mlp_kind": "swiglu",
        "norm_eps": 1e-5, "tie_embeddings": False, "dtype": "float32",
        "param_dtype": "float32"},
}

MIX = {"about": "tiny", "rate_rps": 12.0, "shape_seed": 7,
       "prompt": {"median": 10, "sigma": 0.5, "lo": 2, "hi": 24},
       "decode": {"median": 3, "sigma": 0.5, "lo": 1, "hi": 6},
       "bucket": 24, "max_decode": 6, "ttft_slo_s": 1.0, "tbt_slo_s": 0.5,
       "bytes_per_token": 8, "b_set": [1, 2, 4], "c_set": [1, 2],
       "tick_s": 0.25}


def make_root(tmp: Path) -> Path:
    """A checkout holding the real benchmark's code and metric readers,
    with the tiny configurations and mix in place of the real ones."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, conf in TINY.items():
        (root / "perfbench" / "configs" / f"{name}.json").write_text(
            json.dumps(conf))
    (root / "perfbench" / "traffic" / "tiny.json").write_text(json.dumps(MIX))
    for cell in bench["workloads"]:
        cell["traffic"] = "tiny"
        (root / "perfbench" / "cells" / f"{cell['name']}.json").write_text(
            json.dumps({"logit_gap": 1e-3}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
