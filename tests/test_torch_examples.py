"""The port's five examples (``examples/torch_*.py``), each run on the
CPU at a small size in a fresh Python with one thread.

* ``torch_quickstart.py`` and ``torch_vertical_scaling_demo.py`` drive
  the control plane (``make_sim_server``) and print the same lines as
  the reference's ``quickstart.py`` / ``vertical_scaling_demo.py``: the
  decisions, resizes, violations and core-seconds, all but the solver's
  wall time in microseconds.
* ``torch_fig4_study.py`` prints the reference's ``fig4_study.py``
  lines over a 60 s trace.
* ``torch_serve_dynamic_slo.py --device cpu`` serves a reduced model
  live through the launcher (the kernels' plain versions on the CPU)
  and ``torch_train_smollm.py --device cpu`` trains two steps and
  writes its checkpoint under the test's tmp path.
"""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")


def run(name: str, *args: str, timeout: float = 240) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, name),
                           *args], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def without_solver_wall(text: str) -> str:
    return re.sub(r"IP iterations, \d+ us\)", "IP iterations, <t> us)", text)


def test_every_reference_example_has_a_torch_twin():
    ref = {f for f in os.listdir(EXAMPLES)
           if f.endswith(".py") and not f.startswith("torch_")}
    assert {"torch_" + f for f in ref} <= set(os.listdir(EXAMPLES))
    assert len(ref) == 5


@pytest.mark.parametrize("name,args", [
    ("quickstart.py", ()),
    ("vertical_scaling_demo.py", ()),
    ("fig4_study.py", ("--duration", "60")),
])
def test_example_prints_the_reference_decisions(name, args):
    ours = without_solver_wall(run("torch_" + name, *args))
    ref = without_solver_wall(run(name, *args))
    assert ours == ref
    assert ours.strip()


def test_quickstart_decides_and_serves():
    out = run("torch_quickstart.py")
    assert "first decision: c=" in out and "served 5 requests" in out


def test_serve_dynamic_slo_serves_live_on_the_cpu():
    out = run("torch_serve_dynamic_slo.py", "--device", "cpu",
              "--duration", "2")
    res = json.loads(out[out.index("{"):])
    assert res["n"] > 0 and res["decisions"] > 0 and res["instances"] >= 1
    assert 0.0 <= res["violation_rate"] <= 1.0
    assert "calibrated perf model" in out


def test_train_smollm_trains_and_checkpoints(tmp_path):
    out = run("torch_train_smollm.py", "--device", "cpu", "--steps", "2",
              "--ckpt", str(tmp_path / "ckpt"))
    assert "step     0 loss" in out and "step     1 loss" in out
    assert "(improved)" in out
    assert list((tmp_path / "ckpt").glob("ckpt_*.npz"))
