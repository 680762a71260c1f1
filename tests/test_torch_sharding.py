"""The port's sharding specs and placements against the reference's
``repro.models.sharding``, on the CPU.

Specs are computed from shapes and a mesh description, so most checks
need no process group: the reference's duck-typed ``FakeMesh`` serves
both packages.  For every arch on both production meshes (16 x 16 and
2 x 16 x 16) every leaf's spec equals the reference's: the parameters
(``fsdp`` on and off), the decode cache (``seq_shard`` off and on) and
each input shape's batch.  The port's parameters are unstacked, so a
leaf under ``layers/<i>`` is held against the reference's leaf of layer
i's group without its leading ``None`` (the layer axis); the port's
cache is one (L, ...) stack, as the reference's per-group stacks, so
its specs equal the reference's as they are.  The port's shapes come
from its own ``init_params`` / ``init_cache`` under ``FakeTensorMode``
(shapes and dtypes only).  ``placements``' local shapes are checked on
a fake process group of 256 and 512 ranks, in a subprocess.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import sharding as jsh
from repro.utils.tree import _path_str
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch.dryrun import _shapes_only
from repro_torch.models import api as tapi
from repro_torch.models import sharding as tsh
from repro_torch.models.transformer import layer_groups
from repro_torch.utils.tree import leaves_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class FakeMesh:
    """Duck-typed mesh: only .shape (dict) and .axis_names are consulted."""
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESH = FakeMesh(data=16, model=16)
MESH_MP = FakeMesh(pod=2, data=16, model=16)
MESHES = pytest.mark.parametrize("mesh", [MESH, MESH_MP],
                                 ids=["1pod", "2pod"])


def norm(spec) -> tuple:
    """A spec as a plain tuple (a ``PartitionSpec`` or the port's)."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def jflat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {_path_str(p): norm(x) for p, x in flat}


def tflat(tree) -> dict:
    return {"/".join(map(str, parts)): x
            for parts, x in leaves_with_path(tree)}


def sflat(tree, prefix="") -> dict:
    """A port spec tree as ``{path: spec}`` (a spec is a tuple leaf)."""
    if tsh._is_spec(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(sflat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def ref_path(path: str, cfg) -> tuple[str, bool]:
    """The reference's leaf path of a port parameter path, and whether
    the reference stacks it over layers."""
    parts = path.split("/")
    if parts[0] == "layers":
        i = int(parts[1])
        for g, (_, n) in enumerate(layer_groups(cfg)):
            if i < n:
                return "/".join(["groups", str(g)] + parts[2:]), True
            i -= n
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(["encoder", "groups", "0"] + parts[3:]), True
    return path, False


def port_shapes(cfg, fn):
    with FakeTensorMode(), _shapes_only():
        return fn(cfg)


_PARAMS = {}


def shapes(arch):
    if arch not in _PARAMS:
        jcfg, tcfg = jax_config(arch), get_config(arch)
        jp = jax.eval_shape(lambda: japi.init_params(jax.random.key(0), jcfg))
        tp = port_shapes(tcfg, lambda c: tapi.init_params(
            torch.Generator().manual_seed(0), c))
        _PARAMS[arch] = (jcfg, tcfg, jp, tp)
    return _PARAMS[arch]


# --------------------------------------------------------------------------
# _fit_spec (the reference's cases)
# --------------------------------------------------------------------------

def test_fit_spec_divisibility():
    assert tsh._fit_spec(("model", None), 2, (64, 10), MESH) == ("model", None)
    # 10 doesn't divide 16: dropped
    assert tsh._fit_spec((None, "model"), 2, (64, 10), MESH) == (None, None)
    # tuple axes: prefix that divides survives
    s = tsh._fit_spec((("pod", "data"), None), 2, (4, 8), MESH_MP)
    assert s == (("pod", "data"), None) or s == ("pod", None)


def test_fit_spec_right_alignment():
    # stacked-layer leading dim gets None
    s = tsh._fit_spec(("model", None), 3, (30, 64, 64), MESH)
    assert s == (None, "model", None)


@pytest.mark.parametrize("spec,ndim,shape", [
    ((("pod", "data"), "model"), 2, (64, 48)),
    (("model", ("pod", "data"), None), 3, (16, 4, 7)),
    ((None, "model"), 1, (32,)),
    ((), 0, ()),
    (("model",), 2, (5, 32)),
])
@MESHES
def test_fit_spec_matches_reference(spec, ndim, shape, mesh):
    assert tsh._fit_spec(spec, ndim, shape, mesh) == norm(
        jsh._fit_spec(P(*spec), ndim, shape, mesh))


# --------------------------------------------------------------------------
# every leaf of every arch against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "serving"])
@MESHES
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, mesh, fsdp):
    jcfg, tcfg, jp, tp = shapes(arch)
    ref = jflat(jsh.param_specs(jp, mesh, fsdp=fsdp))
    out = sflat(tsh.param_specs(tp, mesh, fsdp=fsdp))
    seen = set()
    for path, spec in out.items():
        rpath, stacked = ref_path(path, tcfg)
        want = ref[rpath]
        assert spec == (want[1:] if stacked else want), (path, spec, want)
        seen.add(rpath)
    assert seen == set(ref)


@pytest.mark.parametrize("seq_shard", [False, True], ids=["heads", "seq"])
@MESHES
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, mesh, seq_shard):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jc = jax.eval_shape(lambda: japi.init_cache(jcfg, 128, 32768))
    tc = port_shapes(tcfg, lambda c: tapi.init_cache(c, 128, 32768, "cpu"))
    ref = jflat(jsh.cache_specs(jc, mesh, seq_shard=seq_shard))
    out = sflat(tsh.cache_specs(tc, mesh, seq_shard=seq_shard))
    # the port's names for the reference's per-group leaves
    rename = {"k": "kv/k", "v": "kv/v", "c_kv": "kv/c_kv",
              "k_rope": "kv/k_rope"}
    by_name = {}
    for path, spec in ref.items():
        parts = path.split("/")
        if parts[0] == "groups":
            by_name.setdefault("/".join(parts[2:]), set()).add(spec)
        else:
            by_name.setdefault(path, set()).add(spec)
    assert set(out) - {"index"} and "index" in out
    for path, spec in out.items():
        want = by_name[rename.get(path, path)]
        assert want == {spec}, (path, spec, want)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@MESHES
@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_match_reference(arch, mesh, shape):
    jb = japi.input_specs(jax_config(arch), JSHAPES[shape])
    tb = tapi.input_specs(get_config(arch), INPUT_SHAPES[shape])
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tb.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
    assert tsh.batch_specs(tb, mesh) == {
        k: norm(v) for k, v in jsh.batch_specs(jb, mesh).items()}


# --------------------------------------------------------------------------
# the reference's invariants
# --------------------------------------------------------------------------

@MESHES
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_always_divide(arch, mesh):
    _, _, _, tp = shapes(arch)
    specs = sflat(tsh.param_specs(tp, mesh))
    for path, leaf in tflat(tp).items():
        spec = specs[path]
        assert len(spec) == leaf.ndim
        for dim, ax in zip(leaf.shape, spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n = int(np.prod([mesh.shape[a] for a in axes]))
            assert dim % n == 0, (arch, path, leaf.shape, spec)


def test_serving_specs_drop_fsdp():
    _, _, _, tp = shapes("rwkv6-1.6b")
    specs = tsh.param_specs(tp, MESH, fsdp=False)
    for spec in sflat(specs).values():
        for ax in spec:
            axes = ax if isinstance(ax, tuple) else (ax,)
            assert "data" not in axes and "pod" not in axes


def test_moe_experts_keep_two_axis_sharding_when_serving():
    _, tcfg, _, tp = shapes("kimi-k2-1t-a32b")
    specs = tsh.param_specs(tp, MESH, fsdp=False)
    first_moe = layer_groups(tcfg)[0][1]      # after the dense group
    moe_spec = specs["layers"][first_moe]["moe"]["wg"]
    flat = [a for ax in moe_spec if ax is not None
            for a in (ax if isinstance(ax, tuple) else (ax,))]
    assert "model" in flat and "data" in flat


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    assert tsh.placements((("pod", "data"), None, "model"), MESH_MP) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements(("model",), MESH, ndim=3) == (Replicate(),
                                                        Shard(2))
    assert tsh.placements((), MESH) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        tsh.placements(("model", "model"), MESH)


PLACEMENT_SCRIPT = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.dryrun import make_mesh
from repro_torch.models import sharding as sh

multi = sys.argv[1] == "1"
mesh = make_mesh(multi)
cases = [((("pod", "data"), "model"), (64, 48)),
         (("model", ("pod", "data"), None), (16, 64, 7)),
         ((None, ("pod", "data"), None, "model"), (2, 128, 5, 32)),
         ((), (3, 5))]
out = []
with FakeTensorMode():
    for spec, shape in cases:
        spec = sh._fit_spec(spec, len(shape), shape, mesh)
        t = sh.distribute({"x": torch.zeros(shape)}, {"x": spec}, mesh)["x"]
        out.append([list(t.to_local().shape), list(t.shape)])
print(json.dumps(out))
"""


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
def test_placements_local_shapes_on_fake_group(multi_pod):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", PLACEMENT_SCRIPT,
                           "1" if multi_pod else "0"], capture_output=True,
                          text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    dp = 32 if multi_pod else 16
    assert got == [[[64 // dp, 48 // 16], [64, 48]],
                   [[1, 64 // dp, 7], [16, 64, 7]],
                   [[2, 128 // dp, 5, 2], [2, 128, 5, 32]],
                   [[3, 5], [3, 5]]]
