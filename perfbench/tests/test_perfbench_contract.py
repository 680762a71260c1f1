"""BENCHMARK.json keeps the form the benchmark's runner reads."""
import json
import re

from perfbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return spec.load_benchmark()


def test_top_level_keys_and_paths():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells():
    b = _bench()
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        conf = spec.load_config(b, c["name"])
        assert c["reduced"] == conf["reduced"]
        assert (spec.ROOT / "perfbench" / "reference"
                / f"{conf['family']}.py").is_file()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert "logit_gap" in spec.cell_limits(w["name"])
    assert {w["config"] for w in b["workloads"]} == set(names)


def test_metrics():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    seen = set()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert m["name"] not in seen
        seen.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        assert (spec.ROOT / "perfbench" / "metrics"
                / f"{m['name']}.py").is_file()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", moved)) <= moved
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m["name"] for m in spec.cell_metrics(b, cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.cell_metrics(b, cell, True)


def test_the_check_fits_the_time():
    b = _bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert json.loads(json.dumps(b)) == b
