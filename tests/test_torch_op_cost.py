"""The port's per-rank cost counter (``utils.op_cost``) and its op-log
analysis (``utils.op_analysis``) against the reference's HLO cost
analysis (``repro.utils.hlo_cost``), on the CPU.

* A Python loop of n products counts n times one, and nested loops
  multiply (the reference's trip-count weighting, which eager code
  needs none of).
* The bytes of a 10-product chain lie within 3x of the reference's
  ``analyze_weighted`` on the same chain, the bound the reference holds
  its count to against XLA's.
* The reduced smollm-135m's forward counts within 5 % of the FLOPs the
  reference's ``analyze_weighted`` finds in its jitted forward on the
  same batch (found: 2,516,582,400 both, 0.0 % apart).
* On a fake process group, the collectives of one sharded product (a
  partial sum all-reduced, a sharded result all-gathered) have the
  kinds, bytes and counts of a hand count, after the warm-up call and
  without it.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.utils.hlo_cost import analyze_weighted
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.utils import op_analysis
from repro_torch.utils.op_cost import CostMode, analyze

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_loop_of_products_counts_each():
    x = torch.zeros(64, 256)
    ws = torch.zeros(12, 256, 256)

    def chain(n):
        y = x
        for i in range(n):
            y = y @ ws[i]
        return y

    one = analyze(chain, 1, warmup=False).flops
    assert one == 2 * 64 * 256 * 256
    for n in (4, 12):
        assert analyze(chain, n, warmup=False).flops == n * one


def test_nested_loops_multiply():
    x = torch.zeros(32, 64)
    ws = torch.zeros(5, 64, 64)

    def outer():
        y = x
        for i in range(5):
            for _ in range(3):
                y = y @ ws[i]
        return y

    assert analyze(outer, warmup=False).flops == 2 * 32 * 64 * 64 * 3 * 5


def test_bytes_within_factor_of_reference():
    xj = jnp.zeros((128, 512), jnp.float32)
    wsj = jnp.zeros((10, 512, 512), jnp.float32)

    def chain_j(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    ref = analyze_weighted(jax.jit(chain_j).lower(xj, wsj).compile()
                           .as_text()).bytes_accessed
    x, ws = torch.zeros(128, 512), torch.zeros(10, 512, 512)

    def chain(x, ws):
        for i in range(ws.shape[0]):
            x = x @ ws[i]
        return x

    mine = analyze(chain, x, ws, warmup=False).bytes_accessed
    assert ref / 3 < mine < ref * 3, (mine, ref)


def test_smollm_forward_flops_match_reference():
    jcfg = jax_config("smollm-135m", reduced=True)
    model = jax_build(jcfg)
    params = model.init(jax.random.key(0))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    hlo = jax.jit(lambda p, b: model.forward(p, b)[0]).lower(
        params, batch).compile().as_text()
    ref = analyze_weighted(hlo).flops
    cfg = get_config("smollm-135m-reduced")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    tmodel = build_model(cfg, device="cpu")
    with torch.no_grad():
        mine = analyze(tmodel.forward, tparams,
                       {"tokens": torch.from_numpy(tokens)},
                       warmup=False).flops
    assert abs(mine - ref) <= 0.05 * ref, (mine, ref)


def test_op_log_and_stats():
    a, b = torch.ones(4, 8), torch.ones(8, 2)
    with CostMode() as mode:
        (a @ b).sum()
    log = mode.cost.log
    assert [r.op for r in log if r.flops] == ["aten::mm"]
    assert op_analysis.duplicate_op_counts(log) == [("aten::mm", 1)]
    assert op_analysis.collective_stats(log).summary() == "none"
    assert mode.cost.peak_live_bytes >= 4 * 2 * 4
    assert op_analysis.shape_bytes((8, 128), "bf16") == 8 * 128 * 2
    assert op_analysis.tensor_bytes(torch.zeros(3, dtype=torch.int64)) == 24


COLLECTIVE_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.utils.op_analysis import collective_stats
from repro_torch.utils.op_cost import analyze

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
x = distribute_tensor(torch.ones(8, 16), mesh, [Shard(1)])
w = distribute_tensor(torch.ones(16, 32), mesh, [Shard(0)])
a = distribute_tensor(torch.ones(8, 16), mesh, [Shard(0)])
b = distribute_tensor(torch.ones(16, 32), mesh, [Replicate()])

def partial_sum():        # (8, 4) @ (4, 32) per rank, then all-reduce
    return (x @ w).redistribute(mesh, [Replicate()]).to_local()

def gathered():           # (2, 16) @ (16, 32) per rank, then all-gather
    return (a @ b).full_tensor()

out = {}
for name, fn in (("partial", partial_sum), ("gather", gathered)):
    for warm in (True, False):
        wc = analyze(fn, warmup=warm)
        st = collective_stats(wc.log)
        out[f"{name}_{int(warm)}"] = [wc.flops, wc.collective_bytes,
                                      wc.collective_counts,
                                      st.bytes_by_kind, st.count_by_kind]
print(json.dumps(out))
"""


def test_sharded_product_collectives_on_fake_group():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", COLLECTIVE_SCRIPT],
                          capture_output=True, text=True, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for warm in (0, 1):
        assert got[f"partial_{warm}"] == [
            2 * 8 * 4 * 32, {"all-reduce": 8 * 32 * 4},
            {"all-reduce": 1}, {"all-reduce": 8 * 32 * 4},
            {"all-reduce": 1}]
        assert got[f"gather_{warm}"] == [
            2 * 2 * 16 * 32, {"all-gather": 8 * 32 * 4},
            {"all-gather": 1}, {"all-gather": 8 * 32 * 4},
            {"all-gather": 1}]
