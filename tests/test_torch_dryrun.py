"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``, on the CPU.

* ``applicable`` and ``model_flops`` equal the reference's for every
  arch x input shape, and so do ``LONG_OK`` and ``BF16_MOMENT_ARCHS``.
* ``run_one`` on the reduced smollm-135m (dense) and kimi-k2 (MoE) for
  each kind of step (train, prefill, decode), baseline and tuned, on a
  4 x 2 fake mesh with the shapes cut (B 8, S 64), in a subprocess:
  each writes a record with the reference's keys (``trace_s`` in place
  of ``lower_s`` / ``compile_s``) and roofline fields, with per-chip
  FLOPs and bytes, and a train step's collectives.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
from repro.utils.roofline import Roofline as JRoofline
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import dryrun as tdry

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without keeping the
    ``XLA_FLAGS`` it sets for its own process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def test_tables_match_reference():
    jdry = _reference_dryrun()
    assert tdry.LONG_OK == jdry.LONG_OK
    assert tdry.BF16_MOMENT_ARCHS == jdry.BF16_MOMENT_ARCHS
    assert sorted(list_archs()) == sorted(jax_archs())
    assert list(INPUT_SHAPES) == list(JSHAPES)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_applicable_and_model_flops_match_reference(arch, shape):
    jdry = _reference_dryrun()
    assert tdry.applicable(arch, shape) == jdry.applicable(arch, shape)
    assert tdry.model_flops(get_config(arch), INPUT_SHAPES[shape]) == \
        jdry.model_flops(jax_config(arch), JSHAPES[shape])


RUN_SCRIPT = r"""
import json, sys
from repro_torch.launch.dryrun import run_one
out = {}
for arch in ("smollm-135m-reduced", "kimi-k2-1t-a32b-reduced"):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for opt in ("baseline", "tuned"):
            rec = run_one(arch, shape, False, out_dir=sys.argv[1],
                          verbose=False, opt=opt, mesh_shape="4x2",
                          global_batch=8, seq_len=64)
            out[f"{arch}|{shape}|{opt}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", RUN_SCRIPT, str(d)],
                          capture_output=True, text=True, env=env,
                          timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return d, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("opt", ["baseline", "tuned"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["smollm-135m-reduced",
                                  "kimi-k2-1t-a32b-reduced"])
def test_run_one_writes_the_reference_record(records, arch, shape, opt):
    d, recs = records
    rec = recs[f"{arch}|{shape}|{opt}"]
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


ONE_BY_ONE_SCRIPT = r"""
import dataclasses, json
import torch
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.launch.dryrun import run_one
from repro_torch.models import build_model
from repro_torch.train.loop import init_state, make_train_step
from repro_torch.train.optimizer import OptConfig
from repro_torch.utils.op_cost import analyze

torch.set_num_threads(1)
cfg = dataclasses.replace(get_config("smollm-135m-reduced"), remat=True)
model = build_model(cfg, device="cpu")
oc = OptConfig()
state = init_state(model, model.generator(0), oc).as_dict()
batch = make_batch(cfg, 4, 64, 0)
counted = analyze(make_train_step(model, oc), state, batch,
                  warmup=False).flops
rec = run_one("smollm-135m-reduced", "train_4k", False, verbose=False,
              mesh_shape="1x1", global_batch=4, seq_len=64, cfg=cfg)
print(json.dumps([counted, rec["roofline"]["flops_per_chip"]]))
"""


def test_one_by_one_dry_run_counts_the_unsharded_step():
    """The dry run on a 1 x 1 fake mesh counts the FLOPs ``CostMode``
    counts over the same step run unsharded (recompute on): what
    ``chip_smoke.py`` phase ``dist`` leg 3 holds on the card at full
    width."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", ONE_BY_ONE_SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    counted, dry = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counted == dry > 0
