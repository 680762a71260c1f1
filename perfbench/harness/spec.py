"""What a cell is made of, found by name: ``BENCHMARK.json``, the
configuration file, the traffic mix, the metric readers, the reference.

Nothing here names a cell, a configuration, a mix or a metric: a later
change adds one by adding its files and its entry in ``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

from perfbench.harness import traffic

ROOT = Path(__file__).resolve().parents[2]          # the checkout

# the keys of a configuration file that are sizes of the model, each a
# ModelConfig field of the program under the same name
MODEL_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "window_size", "rope_theta",
              "mlp_kind", "norm_eps", "tie_embeddings", "dtype",
              "param_dtype")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """A configuration's file as a dict (its ``file`` entry)."""
    entry = find(bench["configs"], name, "configuration")
    return json.loads((root / entry["file"]).read_text())


def load_mix(name: str, root: Path = ROOT) -> dict:
    return traffic.load_mix(name, root / "perfbench" / "traffic")


def _load(path: Path, name: str) -> ModuleType:
    """A module of the benchmark loaded from its file (a name may hold
    dots and dashes)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + "".join(ch if ch.isalnum() else "_" for ch in name),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(family: str, root: Path = ROOT) -> ModuleType:
    """The plain reference of a family: ``perfbench/reference/<family>.py``."""
    return _load(root / "perfbench" / "reference" / f"{family}.py",
                 f"reference_{family}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    return _load(root / "perfbench" / "metrics" / f"{name}.py",
                 f"metric_{name}").read


def cell_limits(cell: str, root: Path = ROOT) -> dict:
    """The limits of ``correct`` for a cell: ``perfbench/cells/<cell>.json``."""
    return json.loads((root / "perfbench" / "cells" / f"{cell}.json")
                      .read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: with ``trace`` off the
    end-to-end metrics of the cell, with it on its per-layer metrics (an
    entry without ``workloads`` goes to every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def model_fields(conf: dict) -> dict:
    """The configuration file's sizes as the program's ModelConfig fields
    (``blocks`` from ``block`` times ``num_layers``)."""
    fields = {k: conf[k] for k in MODEL_KEYS if k in conf}
    fields["blocks"] = (conf["block"],) * conf["num_layers"]
    return fields
