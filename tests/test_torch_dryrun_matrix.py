"""The port's dry run (``repro_torch.launch.dryrun.run_one``) over every
reduced arch x applicable input shape x {baseline, tuned}, on a 4 x 2
fake mesh with the shapes cut (B 8, S 64), in one subprocess, on the
CPU.

Each combination must trace and write a record with the reference's
keys (``trace_s`` in place of ``lower_s`` / ``compile_s``) and roofline
fields, with per-chip FLOPs and bytes, and a train step's collectives.
The matrix covers the windowed decode over a sequence-sharded ring
cache (h2o-danube-1.8b, zamba2-2.7b's shared block; tuned decode
shapes), deepseek-v3's MTP loss under FSDP (baseline ``train_4k``) and
the chunked SSD / WKV6 training forms on DTensors of fake tensors
(zamba2-2.7b, rwkv6-1.6b ``train_4k``).  ``applicable`` is held to the
reference's in ``tests/test_torch_dryrun.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.utils.roofline import Roofline as JRoofline
from repro_torch.configs import INPUT_SHAPES, list_archs
from repro_torch.launch.dryrun import applicable

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

COMBOS = [(arch + "-reduced", shape, opt)
          for arch in list_archs() for shape in INPUT_SHAPES
          if applicable(arch, shape) for opt in ("baseline", "tuned")]

RUN_SCRIPT = r"""
import json, sys, traceback
import torch
from repro_torch.launch.dryrun import run_one
torch.set_num_threads(1)
out = {}
for arch, shape, opt in json.loads(sys.argv[2]):
    try:
        out[f"{arch}|{shape}|{opt}"] = run_one(
            arch, shape, False, out_dir=sys.argv[1], verbose=False, opt=opt,
            mesh_shape="4x2", global_batch=8, seq_len=64)
    except Exception:
        out[f"{arch}|{shape}|{opt}"] = {"error": traceback.format_exc()[-2000:]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", RUN_SCRIPT, str(d),
                           json.dumps(COMBOS)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d, json.loads(proc.stdout.strip().splitlines()[-1])


def test_matrix_covers_every_applicable_combination():
    assert len(COMBOS) == 66
    assert len({arch for arch, _, _ in COMBOS}) == len(list_archs())


@pytest.mark.parametrize("arch,shape,opt", COMBOS)
def test_run_one_writes_the_reference_record(records, arch, shape, opt):
    d, recs = records
    rec = recs[f"{arch}|{shape}|{opt}"]
    assert "error" not in rec, rec.get("error")
    # the reference's record keys, trace_s for lower_s / compile_s
    assert {"arch", "shape", "mesh", "chips", "trace_s", "ok",
            "roofline"} <= set(rec)
    assert rec["ok"] and rec["chips"] == 8
    assert rec["mesh"] == ("4x2" if opt == "baseline" else "4x2-tuned")
    roof = rec["roofline"]
    assert set(roof) == {f.name for f in dataclasses.fields(JRoofline)}
    assert roof["flops_per_chip"] > 0 and roof["bytes_per_chip"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert set(roof["memory_analysis"]) >= {
        "argument_size_in_bytes", "output_size_in_bytes",
        "peak_memory_in_bytes"}
    if shape == "train_4k":
        assert roof["collective_bytes_per_chip"] > 0
        assert set(roof["collectives"]["bytes"]) <= {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}
    name = d / f"{arch}_{shape}_{rec['mesh']}.json"
    assert json.loads(name.read_text()) == rec
