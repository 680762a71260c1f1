"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``, on the CPU.

* ``applicable`` and ``model_flops`` equal the reference's for every
  arch x input shape, and so do ``LONG_OK`` and ``BF16_MOMENT_ARCHS``.
* On a 1 x 1 fake mesh the dry run counts the FLOPs that ``CostMode``
  counts over the same train step run unsharded: smollm-135m with
  recompute, rwkv6-1.6b's chunked WKV6 form and zamba2-2.7b's chunked
  SSD form (both run per rank through ``local_call``).

``tests/test_torch_dryrun_matrix.py`` runs ``run_one`` over every
reduced arch x applicable shape x {baseline, tuned}.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
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


ONE_BY_ONE_SCRIPT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.launch.dryrun import run_one
from repro_torch.models import build_model
from repro_torch.train.loop import init_state, make_train_step
from repro_torch.train.optimizer import OptConfig
from repro_torch.utils.op_cost import analyze

torch.set_num_threads(1)
arch = sys.argv[1]
cfg = dataclasses.replace(get_config(arch), **json.loads(sys.argv[2]))
model = build_model(cfg, device="cpu")
oc = OptConfig()
state = init_state(model, model.generator(0), oc).as_dict()
batch = make_batch(cfg, 4, 64, 0)
counted = analyze(make_train_step(model, oc), state, batch,
                  warmup=False).flops
rec = run_one(arch, "train_4k", False, verbose=False,
              mesh_shape="1x1", global_batch=4, seq_len=64, cfg=cfg)
print(json.dumps([counted, rec["roofline"]["flops_per_chip"]]))
"""


def one_by_one_flops(arch: str, **knobs) -> tuple:
    """(``CostMode``'s FLOPs of one unsharded train step of ``arch`` at
    B 4 x S 64 with ``knobs`` set in its config, the 1 x 1 dry run's)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", ONE_BY_ONE_SCRIPT, arch,
                           json.dumps(knobs)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tuple(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_one_by_one_dry_run_counts_the_unsharded_step():
    """The dry run on a 1 x 1 fake mesh counts the FLOPs ``CostMode``
    counts over the same step run unsharded (recompute on): what
    ``chip_smoke.py`` phase ``dist`` leg 3 holds on the card at full
    width."""
    counted, dry = one_by_one_flops("smollm-135m-reduced", remat=True)
    assert counted == dry > 0


@pytest.mark.parametrize("arch,knobs", [
    ("rwkv6-1.6b-reduced", {"rwkv_chunked": True}),
    ("zamba2-2.7b-reduced", {}),
])
def test_one_by_one_dry_run_counts_the_unsharded_chunked_step(arch, knobs):
    """The chunked training forms (``wkv6_chunked``, ``ssd_chunked``)
    run per rank through ``local_call`` under a mesh: the 1 x 1 dry run
    counts the unsharded step's FLOPs."""
    counted, dry = one_by_one_flops(arch, **knobs)
    assert counted == dry > 0


SMALL_BATCH_SCRIPT = r"""
import json, sys
import torch
from repro_torch.launch.dryrun import run_one
torch.set_num_threads(1)
out = {}
for arch in ("h2o-danube-1.8b-reduced", "zamba2-2.7b-reduced",
             "smollm-135m-reduced"):
    for gb in (1, 2):
        rec = run_one(arch, "long_500k" if "smollm" not in arch
                      else "decode_32k", False, verbose=False, opt="tuned",
                      mesh_shape="4x2", global_batch=gb, seq_len=64)
        out[f"{arch}|{gb}"] = rec["roofline"]["flops_per_chip"]
print(json.dumps(out))
"""


def test_decode_at_a_batch_the_data_axis_does_not_divide():
    """long_500k decodes one sequence: on the 4 x 2 mesh a batch of 1 or
    2 runs replicated over ``data`` (``_fit_spec``), and the per-rank
    bodies' results keep that layout (``local_call`` fits its out specs
    as it fitted the inputs), over the sequence-sharded ring too."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", SMALL_BATCH_SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    flops = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(flops) == 6 and all(f > 0 for f in flops.values())
