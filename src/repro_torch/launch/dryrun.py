"""Multi-pod dry run: trace every (arch x input shape) on the production
meshes and record the per-device cost, the memory and an H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k [--multi-pod] [--opt tuned] [--out experiments/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each step for 512 placeholder XLA devices; here the program
starts a fake process group of 256 (one pod) or 512 (two pods) ranks
in this one process, builds the state as DTensors of fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage), and runs one step
under ``utils.op_cost.CostMode``, which counts rank 0's local ops and
collectives.  Decode shapes run ``decode_step`` (one token against a
full-size cache), prefill ``prefill``, train ``train_step`` (forward,
backward and AdamW).  long_500k runs only for the sub-quadratic archs.
The kernel routes are off (``use_pallas_*`` False, as in the
reference's configs): a kernel cannot run on fake tensors.  It is a CPU
tool by nature: its mesh's device type is ``cpu``, and that is no
fallback.  The record's roofline is a prediction from the H100's
constants (``utils.roofline``), not a measurement; ``trace_s`` (the
time to build the state and run the counted step) takes the place of
the reference's ``lower_s`` / ``compile_s``, and ``memory_analysis``
holds rank 0's argument and output bytes (its local shards) and the
mode's peak of live bytes beside them.

``--mesh DxM`` (a ``data x model`` mesh in place of the production one)
and ``--global-batch`` / ``--seq-len`` (a shape's sizes replaced) size
a run to compare with a measured step on one card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import InputShape, ModelConfig

# long_500k runs only for bounded-state archs
LONG_OK = {"zamba2-2.7b", "rwkv6-1.6b", "h2o-danube-1.8b"}
# the MoE giants need bf16 optimizer moments to have any chance of fitting
BF16_MOMENT_ARCHS = {"deepseek-v3-671b", "kimi-k2-1t-a32b"}


def applicable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return False
    return True


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    per_tok = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    return per_tok * n_active * tokens


def start_fake_group(world: int) -> None:
    """The default process group: ``world`` fake ranks in this process,
    this one rank 0 (collectives return at once, moving nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(multi_pod: bool, shape: str | None = None):
    """The production mesh on the fake group (``shape`` ``"DxM"``: a
    ``data x model`` mesh instead), device type ``cpu``."""
    from repro_torch.launch.mesh import make_production_mesh, make_small_mesh

    if shape:
        d, m = (int(x) for x in shape.lower().split("x"))
        start_fake_group(d * m)
        return make_small_mesh(d, m, device_type="cpu")
    start_fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


@contextlib.contextmanager
def _shapes_only():
    """``torch.nn.init.trunc_normal_`` made a no-op: its rejection loop
    reads values, which fake tensors do not have (the dry run needs the
    parameters' shapes and dtypes only)."""
    saved = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = lambda t, *a, **k: t
    try:
        yield
    finally:
        torch.nn.init.trunc_normal_ = saved


def dryrun_config(arch: str, shape: InputShape, opt: str = "baseline"
                  ) -> tuple[ModelConfig, bool]:
    """(config, fsdp) of a run: the kernel routes off; ``opt="tuned"``
    applies the reference's beyond-paper settings (serving params
    without FSDP gathers, partial-sum EP for MoE, batch-parallel
    attention for small-head archs, chunked RWKV)."""
    cfg = dataclasses.replace(get_config(arch), use_pallas_prefill=False,
                              use_pallas_decode=False)
    fsdp = True
    if opt == "tuned":
        if shape.kind == "decode":
            fsdp = False
        # small models: ZeRO-3 buys nothing (state fits replicated over
        # data) and costs per-layer gathers
        if shape.kind == "train" and cfg.param_count() < 1e9:
            fsdp = False
        if cfg.uses_moe:
            cfg = dataclasses.replace(cfg, moe_partial_ep=True)
        if (cfg.num_heads * cfg.head_dim) % 16 != 0 or cfg.num_heads < 16 \
                or cfg.num_kv_heads < 16:
            cfg = dataclasses.replace(cfg, attn_batch_parallel=True)
        if "rwkv6" in cfg.mixer_kinds:
            cfg = dataclasses.replace(cfg, rwkv_chunked=True)
    return cfg, fsdp


def _local_bytes(tree) -> int:
    """Bytes of rank 0's shards of every tensor of a tree."""
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.tree import tree_leaves

    n = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            n += t.numel() * t.element_size()
    return n


def build_step(arch: str, shape: InputShape, mesh, opt: str = "baseline",
               cfg: ModelConfig | None = None):
    """Returns ``(fn, args)``: the step and its inputs as DTensors of
    fake tensors, built under the caller's ``FakeTensorMode``.  opt:
    baseline | tuned (``dryrun_config``)."""
    from repro_torch.models import sharding as sh
    from repro_torch.models.api import build_model, input_specs
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optimizer import OptConfig

    base, fsdp = dryrun_config(arch, shape, opt)
    cfg = cfg or base
    oc = (OptConfig(moment_dtype="bfloat16") if arch in BF16_MOMENT_ARCHS
          else OptConfig())
    model = build_model(cfg, mesh=mesh, device="cpu")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in input_specs(cfg, shape).items()}
    batch = {k: sh.constrain(v, mesh, sh.batch_specs({k: v}, mesh)[k])
             for k, v in batch.items()}
    with _shapes_only():
        if shape.kind == "train":
            state = init_state(model, model.generator(0), oc,
                               fsdp=fsdp).as_dict()
            return make_train_step(model, oc), (state, batch)
        params = model.init(model.generator(0))
    params = sh.distribute(params, sh.param_specs(params, mesh, fsdp=fsdp),
                           mesh)

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch)
        return prefill_fn, (params, batch)

    # decode: one token against a full-length cache
    from repro_torch.models.api import init_cache
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, "cpu", mesh,
                       seq_shard=(opt == "tuned"))

    def serve_step(params, cache, batch):
        with torch.no_grad():
            return model.decode_step(params, cache, batch["token"],
                                     batch.get("mrope_positions"))
    return serve_step, (params, cache, batch)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str | None = None, verbose: bool = True,
            opt: str = "baseline", mesh_shape: str | None = None,
            global_batch: int | None = None, seq_len: int | None = None,
            cfg: ModelConfig | None = None) -> dict:
    """One dry run; returns (and with ``out_dir`` writes) its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import chips, mesh_name
    from repro_torch.utils import roofline as rf
    from repro_torch.utils.op_analysis import duplicate_op_counts
    from repro_torch.utils.op_cost import CostMode

    shape = INPUT_SHAPES[shape_name]
    shape = dataclasses.replace(
        shape, global_batch=global_batch or shape.global_batch,
        seq_len=seq_len or shape.seq_len)
    from repro_torch.models import common

    mesh = make_mesh(multi_pod, mesh_shape)
    mname = mesh_name(mesh) if opt == "baseline" else \
        f"{mesh_name(mesh)}-{opt}"
    t0 = time.perf_counter()
    # RoPE's frequency tables are cached per device: a real table must
    # not meet fake tensors, nor a fake one outlive its mode
    common._FREQS.clear()
    with FakeTensorMode():
        fn, args = build_step(arch, shape, mesh, opt=opt, cfg=cfg)
        t_build = time.perf_counter() - t0
        arg_bytes = _local_bytes(args)
        if not CostMode.hides_propagation():
            fn(*args)                # fills DTensor's propagation cache
        with CostMode() as mode:
            out = fn(*args)
        out_bytes = _local_bytes(out)
    common._FREQS.clear()
    t_trace = time.perf_counter() - t0
    wc = mode.cost
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": int(wc.peak_live_bytes),
           "peak_memory_in_bytes": int(arg_bytes + wc.peak_live_bytes)}
    cfg = cfg or dryrun_config(arch, shape, opt)[0]
    roof = rf.analyze(arch, shape_name, mname, chips(mesh), wc,
                      model_flops(cfg, shape), memory_analysis=mem,
                      note="prediction from H100 SXM constants")
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mname,
        "chips": chips(mesh),
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
        "ops": len(wc.log),
        "top_ops": duplicate_op_counts(wc.log, 5),
        "ok": True,
        "roofline": json.loads(roof.to_json()),
        "step_time_s": roof.step_time_s,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} @ {mname}: OK "
              f"(build {t_build:.0f}s trace {t_trace:.0f}s, "
              f"{len(wc.log)} ops)")
        print(f"  memory_analysis: {rec['roofline']['memory_analysis']}")
        print(f"  cost: flops/chip={roof.flops_per_chip:.3e} "
              f"bytes/chip={roof.bytes_per_chip:.3e}")
        print(f"  collectives: {rec['roofline']['collectives']}")
        print(f"  roofline: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"dominant={roof.dominant} useful={roof.useful_ratio:.2f}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = os.path.join(out_dir, f"{arch}_{shape_name}_{mname}.json")
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--opt", default="baseline",
                    choices=("baseline", "tuned"))
    ap.add_argument("--mesh", default=None,
                    help="a DxM data x model mesh in place of the "
                         "production one")
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--json", action="store_true",
                    help="print each record as one JSON line")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    combos = []
    if args.all:
        for arch in list_archs():
            for shape in INPUT_SHAPES:
                if applicable(arch, shape):
                    if args.both_meshes:
                        combos.append((arch, shape, False))
                        combos.append((arch, shape, True))
                    else:
                        combos.append((arch, shape, args.multi_pod))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        combos = [(args.arch, args.shape, args.multi_pod)]

    failures = []
    for arch, shape, mp in combos:
        try:
            rec = run_one(arch, shape, mp, out_dir=args.out, opt=args.opt,
                          mesh_shape=args.mesh,
                          global_batch=args.global_batch,
                          seq_len=args.seq_len)
            if args.json:
                print(json.dumps(rec))
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape, mp, repr(e)))
            print(f"[dryrun] {arch} x {shape} multi_pod={mp}: FAIL {e}")
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print(f"[dryrun] all {len(combos)} combos OK")


if __name__ == "__main__":
    main()
