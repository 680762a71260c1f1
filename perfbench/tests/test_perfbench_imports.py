"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
references load nothing of the port."""
import ast
import json
import subprocess
import sys

from perfbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

HARNESS = """
import json, sys
sys.argv = ["run.py"]
import perfbench.run, perfbench.calibrate
from perfbench.harness import (check, layers, measure, serve, spec, stats,
                               trace, traffic, weights)
import repro_torch.serving.token_backend, repro_torch.core.scaler
import repro_torch.serving.api, repro_torch.core.slo, repro_torch.kernels.build
bench = spec.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.metric_reader(m["name"])
for c in bench["configs"]:
    spec.reference(spec.load_config(bench, c["name"])["family"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
from perfbench.harness import spec
bench = spec.load_benchmark()
for c in bench["configs"]:
    spec.reference(spec.load_config(bench, c["name"])["family"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert "repro_torch" in names
    assert not names & FORBIDDEN


def test_the_references_load_nothing_of_the_port():
    names = _top_level(REFERENCE)
    assert not names & (FORBIDDEN | {"repro_torch"})


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    files = [p for p in (spec.ROOT / "perfbench").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        names = set(_imports(p))
        assert not names & FORBIDDEN, p
        if "reference" in p.parts:
            assert "repro_torch" not in names, p
        text = p.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, p
