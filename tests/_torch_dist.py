"""Multi-rank runs for the port's distribution tests.

``run_ranks`` writes a script into the test's ``tmp_path`` and runs it
in a fresh Python: it spawns ``world`` gloo ranks on the CPU
(``torch.multiprocessing``), which meet through a ``FileStore`` under
``tmp_path`` (no port, so parallel test workers never collide), run the
``body`` (the text of a function ``body(rank, args)``) and rank 0
writes its JSON result.  The subprocess has a timeout of its own and
imports no JAX; a test computes the reference's side in its own
process and passes files through ``args``.  The sharded train-step
check of ``test_torch_distributed*.py`` lives here too, so that its
archs can be spread over two test files.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

_TEMPLATE = '''\
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def body(rank, args):
{body}


def main(rank, world, store, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        result = body(rank, args)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(main, args=(world, store, out, json.loads(sys.argv[4])),
             nprocs=world)
'''


def run_ranks(body: str, world: int, tmp_path, args=None,
              timeout: float = 300) -> dict:
    """``body`` on ``world`` gloo ranks in a subprocess; rank 0's
    result."""
    script = tmp_path / "ranks.py"
    script.write_text(_TEMPLATE.format(body=textwrap.indent(
        textwrap.dedent(body), "    ")))
    out = tmp_path / "result.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, str(script), str(world), str(tmp_path / "store"),
         str(out), json.dumps(args or {})],
        capture_output=True, text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


# ---------------------------------------------------------------------------
# one sharded train step against the single-device one
# ---------------------------------------------------------------------------

B, S = 4, 16
LR = 1e-3

TRAIN_BODY = '''
import pickle
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import sharding as sh
from repro_torch.train import loop as tloop
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.utils.tree import leaves_with_path

mesh = make_small_mesh(4, 2, device_type="cpu")
with open(args["weights"], "rb") as f:
    weights = pickle.load(f)
res = {}
for arch in args["archs"]:
    cfg = get_config(arch + "-reduced")
    oc = OptConfig(lr=args["lr"])
    batch = make_batch(cfg, args["B"], args["S"], 0)
    one = build_model(cfg, device="cpu")
    p1 = params_from_jax(weights[arch], cfg, "cpu")
    s1, m1 = tloop.make_train_step(one, oc)(
        {"params": p1, "opt": adamw_init(p1, oc)}, batch)
    two = build_model(cfg, mesh=mesh, device="cpu")
    p2 = params_from_jax(weights[arch], cfg, "cpu")
    s2 = sh.distribute({"params": p2, "opt": adamw_init(p2, oc)},
                       tloop.state_specs(p2, mesh), mesh)
    s2, m2 = tloop.make_train_step(two, oc)(s2, batch)
    whole = dict(leaves_with_path(sh.gather(s2["params"])))
    worst, leaf = -1.0, ""
    for parts, a in leaves_with_path(s1["params"]):
        excess = float(((whole[parts] - a).abs()
                        - (1e-5 + 1e-4 * a.abs())).max())
        if excess > worst:
            worst, leaf = excess, "/".join(map(str, parts))
    full = lambda t: float(t.full_tensor() if hasattr(t, "full_tensor")
                           else t)
    res[arch] = {"loss1": float(m1["loss"]), "loss2": full(m2["loss"]),
                 "g1": float(m1["grad_norm"]), "g2": full(m2["grad_norm"]),
                 "excess": worst, "leaf": leaf,
                 "sharded": sum(any(p.is_shard() for p in x.placements)
                                for _, x in leaves_with_path(s2["params"]))}
return res
'''


def reference_train(archs, path) -> dict:
    """The reference's ``key(0)`` weights of each reduced arch, saved to
    ``path`` for the ranks, and its jitted single-device step's loss from
    them on the same batch."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.data import make_batch as jax_make_batch
    from repro.models import build_model as jax_build
    from repro.train import loop as jloop
    from repro.train import optimizer as jopt

    weights, losses = {}, {}
    for arch in archs:
        cfg = jax_config(arch, reduced=True)
        model = jax_build(cfg)
        oc = jopt.OptConfig(lr=LR)
        state = jloop.init_state(model, jax.random.key(0), oc).as_dict()
        weights[arch] = jax.tree.map(np.asarray, state["params"])
        batch = jax_make_batch(cfg, B, S, 0)
        _, met = jax.jit(jloop.make_train_step(model, oc))(state, batch)
        losses[arch] = float(met["loss"])
    with open(path, "wb") as f:
        pickle.dump(weights, f)
    return losses


def sharded_train(archs, tmp_path) -> dict:
    """Per arch: the sharded and single-device steps' metrics, the
    worst parameter excess over 1e-5 + 1e-4 |p| and the reference's
    loss (``ref``)."""
    ref = reference_train(archs, tmp_path / "weights.pkl")
    res = run_ranks(TRAIN_BODY, 8, tmp_path,
                    {"archs": list(archs), "weights":
                     str(tmp_path / "weights.pkl"), "lr": LR, "B": B,
                     "S": S}, timeout=400)
    for arch in archs:
        res[arch]["ref"] = ref[arch]
    return res


def check_train(r: dict) -> None:
    """The sharded step against the single-device one: the loss within
    1e-5 relative (and against the reference's), the gradient norm
    within 1e-4 relative, every parameter within 1e-5 + 1e-4 |p|."""
    assert abs(r["loss2"] - r["loss1"]) <= 1e-5 * abs(r["loss1"]), r
    assert abs(r["loss2"] - r["ref"]) <= 1e-5 * abs(r["ref"]), r
    assert abs(r["g2"] - r["g1"]) <= 1e-4 * abs(r["g1"]), r
    assert r["excess"] <= 0.0, r
    assert r["sharded"] > 0, r
