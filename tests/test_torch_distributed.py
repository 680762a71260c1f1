"""The port's sharded train and serve steps on 8 gloo ranks (a 4 x 2
``("data", "model")`` mesh, as the reference's multi-device test), on
the CPU.

* One sharded train step of the reduced smollm-135m and deepseek-v3-671b
  (MoE expert-parallel, MLA, MTP) in f32 at B 4, S 16 (deepseek-v3 at
  B 8, S 64 too, where the MTP logits meet the FSDP specs), from the
  reference's ``key(0)`` weights (``params_from_jax``), against the
  port's single-device step: the loss within 1e-5 relative, the
  gradient norm within 1e-4 relative and every parameter within
  1e-5 + 1e-4 |p|; the loss also within 1e-5 of the reference's jitted
  single-device step.  The target is the single-device result (the
  reference's own sharded test is red).  ``test_torch_distributed_ssm.py``
  holds zamba2-2.7b and rwkv6-1.6b.
* A sharded prefill (B 4, S 16) and 4 greedy decode steps of the reduced
  smollm-135m, kimi-k2-1t-a32b (``moe_partial_ep``: the partial-sum EP
  path) and h2o-danube-1.8b (a 16-slot ring buffer, which the decode
  steps wrap) with serving specs (``fsdp=False``): the ids equal the
  unsharded ones, with the cache's heads over ``model`` and with its
  sequence over ``model`` (``seq_shard``: each rank attends over its own
  rows and the ranks' softmax parts are merged), on the plain route and
  on the kernel route (``use_pallas_decode``: per rank the kernel's
  plain version on the CPU with its log-sum-exp, the ranks' outputs
  merged by it).
"""
import pytest

from _torch_dist import check_train, run_ranks, sharded_train

TRAIN_ARCHS = ("smollm-135m", "deepseek-v3-671b")
SERVE_ARCHS = ("smollm-135m", "kimi-k2-1t-a32b", "h2o-danube-1.8b")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return sharded_train(TRAIN_ARCHS, tmp_path_factory.mktemp("train"))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_single_device(arch, trained):
    check_train(trained[arch])


def test_mtp_train_step_at_b8_s64_matches_single_device(tmp_path):
    """deepseek-v3's MTP loss under FSDP at B 8 x S 64: the head's
    logits are placed as ``forward`` places them, so the loss's gather
    meets no pending sum."""
    check_train(sharded_train(("deepseek-v3-671b",), tmp_path, 8, 64)
                ["deepseek-v3-671b"])


SERVE_BODY = '''
import dataclasses
import torch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.models.api import init_cache

mesh = make_small_mesh(4, 2, device_type="cpu")
res = {}
for arch in args["archs"]:
    cfg = get_config(arch + "-reduced")
    if cfg.uses_moe:
        cfg = dataclasses.replace(cfg, moe_partial_ep=True)
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for name, m in (("one", None), ("mesh", mesh), ("seq", mesh),
                    ("seqk", mesh)):
        # "seqk": the kernel route over the sequence-sharded cache
        model = build_model(dataclasses.replace(
            cfg, use_pallas_decode=name == "seqk"), mesh=m, device="cpu")
        params = model.init(model.generator(0))
        if m is not None:
            params = sh.distribute(params, sh.param_specs(params, m,
                                                          fsdp=False), m)
        # "seq": the cache's sequence dim over "model" (seq_shard)
        cache = (init_cache(cfg, 4, 20, "cpu", m, seq_shard=True)
                 if name.startswith("seq") else None)
        ids = []
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": toks},
                                          cache_len=20, cache=cache)
            for _ in range(4):
                whole = sh.gather({"x": logits})["x"]
                nxt = whole.argmax(-1)[:, None]
                ids.append(nxt[:, 0].tolist())
                logits, cache = model.decode_step(params, cache, nxt)
        out[name] = ids
        out[name + "_dtensor_cache"] = sh.is_dtensor(cache["index"])
        out[name + "_seq_sharded"] = sh.is_dtensor(cache["k"]) and any(
            p.is_shard(2) for p in cache["k"].placements)
    res[arch] = out
return res
'''


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run_ranks(SERVE_BODY, 8, tmp_path_factory.mktemp("serve"),
                     {"archs": list(SERVE_ARCHS)})


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serve_gives_the_unsharded_ids(arch, served):
    r = served[arch]
    assert r["mesh_dtensor_cache"] and not r["one_dtensor_cache"]
    assert r["seq_seq_sharded"] and not r["mesh_seq_sharded"]
    assert r["mesh"] == r["one"], r
    assert r["seq"] == r["one"], r
    assert r["seqk"] == r["one"], r
