"""The command: its last line's form, and where it must fail."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import perfbench_tiny
from perfbench import run as cli
from perfbench.harness import measure, spec, trace

ARGS = ["--workload", "danube-docs", "--seed", "3000000001", "--seconds",
        "1", "--trace", "0"]


def _cmd(root):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)


def test_the_command_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would run the cell")
    out = _cmd(spec.ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder alone."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cmd(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def test_forbidden_modules_are_named_whole():
    assert cli.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "jaxtyping", "numpy"]) == []
    assert cli.forbidden_modules(["repro_torch", "repro.core", "jax.numpy",
                                  "flax"]) == ["flax", "jax", "repro"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_the_last_line(tmp_path, trace):
    root = perfbench_tiny.make_root(tmp_path)
    bench = spec.load_benchmark(root)
    cell = spec.find(bench["workloads"], "danube-chat-sat", "workload")
    result, lines = measure.run(bench, cell, 2**31 + 77, 2.0, trace,
                                time.perf_counter(), device="cpu", root=root)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == result["generator"]["sent"] > 0
    want = {m["name"] for m in spec.cell_metrics(bench, "danube-chat-sat", trace)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    for name, number in line["check"].items():
        assert set(number) == {"value", "limit"}
        assert any(name in text for text in lines)


def test_the_profilers_stall_is_left_out_of_the_window(tmp_path, monkeypatch):
    """The profiler's collection holds the loop; the window's clock stops
    meanwhile, so no request that arrives after the slice is seen late by
    the stall."""
    stall = 8.0
    due, pause = trace.Tracer.due, trace.Tracer.pause

    def early_due(self, now, start, length):     # a slice at 0.3-0.6 s
        return due(self, now, 0.3, 0.3)

    def slow_pause(self):
        pause(self)
        time.sleep(stall)
        self.t_collect = time.perf_counter() - self.t1

    monkeypatch.setattr(trace.Tracer, "due", early_due)
    monkeypatch.setattr(trace.Tracer, "pause", slow_pause)
    root = perfbench_tiny.make_root(tmp_path)
    bench = spec.load_benchmark(root)
    cell = spec.find(bench["workloads"], "danube-chat-sat", "workload")
    result, _ = measure.run(bench, cell, 2**31 + 78, 3.0, True,
                            time.perf_counter(), device="cpu", root=root)
    assert result["correct"]
    gen = result["generator"]
    assert gen["trace_collect_s"] >= stall
    # most requests arrive after the slice: without the stop the loop
    # would see them up to the stall late
    assert gen["late_max_s"] < stall / 2
