"""Parameter, cache and batch sharding specs (path-regex rules) and their
DTensor placements.

Counterpart of ``repro.models.sharding``: Megatron-style tensor
parallelism over "model" + ZeRO-3/FSDP over ("pod", "data") for the
large matrices.  Rules are matched against a leaf's path (first match
wins) and the spec is right-aligned against the leaf's rank.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dim (right-aligned), each ``None``, an axis name or a tuple
of axis names.  The parameter rules are the reference's regexes, which
match the port's leaf paths as they are (``layers/<i>/attn/wq`` ends
as the reference's ``groups/<g>/attn/wq``; the port's layers are
unstacked, so a leaf's spec is the reference's without the leading
``None`` of the layer axis).  The cache rules are written for the
port's cache, one (L, ...) stack over the groups: ``k``, ``v``,
``c_kv``, ``k_rope`` at the top, ``cross/{k,v}``, ``shared/{k,v}``,
``ssm/*``, ``tmix/*``, ``cmix/shift`` and ``index``.

``placements`` turns a spec into DTensor placements, one per mesh dim
(``Shard(d)`` or ``Replicate()``): a tensor dim sharded over a tuple of
axes gets ``Shard(d)`` on each of them, in mesh order, so ``pod`` is
major.  ``distribute`` places a tree by its specs and ``gather`` brings
it back whole.  The reference's ``shard_map_compat`` has no counterpart:
``torch.distributed.tensor.experimental.local_map`` needs no version
shim.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any

import torch

from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.utils.tree import tree_map_with_path

FSDP = ("pod", "data")

# (path regex, spec over trailing dims)
PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / heads
    (r"embed$", ("model", FSDP)),
    (r"pos_emb$", (None, "model")),
    (r"head$", (FSDP, "model")),
    # attention
    (r"attn/w[qkv]$", (FSDP, "model")),
    (r"attn/wo$", ("model", FSDP)),
    (r"cross/w[qkv]$", (FSDP, "model")),
    (r"cross/wo$", ("model", FSDP)),
    # MLA
    (r"mla/w_dq$", (FSDP, None)),
    (r"mla/w_uq$", (FSDP, "model")),
    (r"mla/w_dkv$", (FSDP, None)),
    (r"mla/w_uk$", (FSDP, "model")),
    (r"mla/w_uv$", (FSDP, "model")),
    (r"mla/wo$", ("model", FSDP)),
    # dense MLP
    (r"mlp/w_(gate|up)$", (FSDP, "model")),
    (r"mlp/w_down$", ("model", FSDP)),
    # MoE (experts over model, FSDP over d_model dim)
    (r"moe/w[gu]$", ("model", FSDP, None)),
    (r"moe/wd$", ("model", None, FSDP)),
    (r"moe/router$", ()),
    (r"moe/router_bias$", ()),
    (r"moe/shared/w_(gate|up)$", (FSDP, "model")),
    (r"moe/shared/w_down$", ("model", FSDP)),
    # mamba2
    (r"mamba/w_zx$", (FSDP, "model")),
    (r"mamba/w_bc$", (FSDP, None)),
    (r"mamba/w_dt$", (FSDP, "model")),
    (r"mamba/conv_x$", (None, "model")),
    (r"mamba/conv_bc$", ()),
    (r"mamba/norm$", ("model",)),
    (r"mamba/w_out$", ("model", FSDP)),
    # rwkv6
    (r"tmix/w_[rkvg]$", (FSDP, "model")),
    (r"tmix/w_o$", ("model", FSDP)),
    (r"tmix/decay_b$", (None, "model")),
    (r"tmix/decay_base$", ("model",)),
    (r"tmix/bonus_u$", ("model", None)),
    (r"tmix/(ln_scale|ln_bias)$", ("model",)),
    (r"cmix/w_k$", (FSDP, "model")),
    (r"cmix/w_v$", ("model", FSDP)),
    (r"cmix/w_r$", (FSDP, None)),
    # everything else (norm scales, mus, biases, loras): replicated
    (r".*", ()),
]

CACHE_RULES: list[tuple[str, tuple]] = [
    # KV caches: batch over data axes, heads over model
    (r"^[kv]$", (FSDP, None, "model", None)),
    (r"^cross/[kv]$", (FSDP, None, "model", None)),
    (r"^shared/[kv]$", (FSDP, None, "model", None)),
    # MLA latent cache: batch over data only (latent dim small)
    (r"^c_kv$", (FSDP, None, None)),
    (r"^k_rope$", (FSDP, None, None)),
    # SSM / RWKV states: batch over data, heads/channels over model
    (r"ssm/conv_x$", (FSDP, None, "model")),
    (r"ssm/conv_bc$", (FSDP, None, None)),
    (r"ssm/h$", (FSDP, "model", None, None)),
    (r"tmix/shift$", (FSDP, "model")),
    (r"tmix/wkv$", (FSDP, "model", None, None)),
    (r"cmix/shift$", (FSDP, "model")),
    (r"index$", ()),
    (r".*", ()),
]

# decode-tuned cache rules: the cache SEQUENCE dim shards over "model", so
# each rank reads 1/n_model of the cache; head-dim sharding is dropped
# (kv heads rarely divide 16).  The in-place cache write stays local: the
# rank holding the written row writes it.
CACHE_RULES_SEQSHARD: list[tuple[str, tuple]] = [
    (r"^[kv]$", (FSDP, "model", None, None)),
    (r"^cross/[kv]$", (FSDP, "model", None, None)),
    (r"^shared/[kv]$", (FSDP, "model", None, None)),
    (r"^c_kv$", (FSDP, "model", None)),
    (r"^k_rope$", (FSDP, "model", None)),
] + CACHE_RULES[5:]

BATCH_RULES: list[tuple[str, tuple]] = [
    (r"(tokens|labels|token)$", (FSDP, None)),
    (r"prefix_embeds$", (FSDP, None, None)),
    (r"enc_embeds$", (FSDP, None, None)),
    (r"mrope_positions$", (None, FSDP, None)),
    (r".*", ()),
]


def _match(path: str, rules) -> tuple:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


def _prod(sizes: dict, axes) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fit_spec(spec: tuple, ndim: int, shape, mesh) -> tuple:
    """Right-align spec to ndim; drop axes that don't divide the dim."""
    sizes = axis_sizes(mesh)
    entries = list(spec)
    if len(entries) > ndim:
        entries = entries[-ndim:] if ndim else []
    entries = [None] * (ndim - len(entries)) + entries
    fixed = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in sizes)
        n = _prod(sizes, axes) if axes else 1
        if n <= 1 or dim % n != 0:
            # try a prefix of the axes tuple that divides
            while axes and dim % _prod(sizes, axes):
                axes = axes[:-1]
            if not axes:
                fixed.append(None)
                continue
        fixed.append(axes if len(axes) > 1 else axes[0])
    return tuple(fixed)


def _specs_for(tree: Any, rules, mesh) -> Any:
    def fn(path, leaf):
        spec = _match(path, rules)
        return _fit_spec(spec, leaf.ndim, leaf.shape, mesh)

    return tree_map_with_path(fn, tree)


def _drop_fsdp(spec: tuple) -> tuple:
    out = []
    for ax in spec:
        if ax is None:
            out.append(None)
            continue
        kept = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                     if a not in FSDP)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def param_specs(params_shape: Any, mesh, fsdp: bool = True) -> Any:
    """Spec tree for a params (shape) tree.

    fsdp=False (serving): drop the ("pod","data") ZeRO-3 axes from all
    non-expert params so decode steps do not all-gather weights every
    token.  MoE expert weights keep their two-axis sharding: the
    partial-sum EP path consumes them in place (moe_partial_ep)."""
    def fn(path, leaf):
        spec = _match(path, PARAM_RULES)
        if not fsdp and not re.search(r"moe/w[gud]$", path):
            spec = _drop_fsdp(spec)
        return _fit_spec(spec, leaf.ndim, leaf.shape, mesh)

    return tree_map_with_path(fn, params_shape)


def cache_specs(cache_shape: Any, mesh, seq_shard: bool = False) -> Any:
    rules = CACHE_RULES_SEQSHARD if seq_shard else CACHE_RULES
    return _specs_for(cache_shape, rules, mesh)


def batch_specs(batch_shape: Any, mesh) -> Any:
    return _specs_for(batch_shape, BATCH_RULES, mesh)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh, ndim: int | None = None) -> tuple:
    """One ``Shard(d)`` / ``Replicate()`` per mesh dim for ``spec``
    (right-aligned to ``ndim`` when given)."""
    from torch.distributed.tensor import Replicate, Shard

    entries = list(spec)
    if ndim is not None:
        entries = [None] * (ndim - len(entries)) + entries
    out = []
    for name in axis_names(mesh):
        dims = [d for d, ax in enumerate(entries) if ax is not None
                and name in (ax if isinstance(ax, tuple) else (ax,))]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards two dims in {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def shardings(spec_tree: Any, mesh) -> Any:
    """The placements of every spec of a spec tree (same structure)."""
    if _is_spec(spec_tree):
        return placements(spec_tree, mesh)
    if isinstance(spec_tree, dict):
        return {k: shardings(v, mesh) for k, v in spec_tree.items()}
    return type(spec_tree)(shardings(v, mesh) for v in spec_tree)


def _spec_at(spec_tree: Any, parts: tuple):
    for p in parts:
        spec_tree = spec_tree[p]
    return spec_tree


def distribute(tree: Any, spec_tree: Any, mesh) -> Any:
    """Every leaf of ``tree`` as a DTensor on ``mesh`` placed by its spec
    in ``spec_tree`` (``distribute_tensor``; every rank passes the same
    whole tensor)."""
    from torch.distributed.tensor import distribute_tensor

    def fn(path, leaf):
        parts = tuple(int(p) if p.isdigit() else p for p in path.split("/"))
        spec = _spec_at(spec_tree, parts) if path else spec_tree
        return distribute_tensor(leaf, mesh, placements(spec, mesh,
                                                        leaf.ndim))

    return tree_map_with_path(fn, tree)


def gather(tree: Any) -> Any:
    """Every DTensor leaf back as the whole tensor (``full_tensor``)."""
    from torch.distributed.tensor import DTensor

    return tree_map_with_path(
        lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


# ---------------------------------------------------------------------------
# per-rank bodies and collectives
# ---------------------------------------------------------------------------

def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as
    replicated (every rank holds the same whole tensor)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x, mesh, spec):
    """``x`` redistributed to ``spec`` on ``mesh`` (axes the mesh lacks,
    or that do not divide, dropped): the reference's
    ``with_sharding_constraint``."""
    if mesh is None:
        return x
    spec = _fit_spec(spec, x.ndim, x.shape, mesh)
    return as_dtensor(x, mesh).redistribute(mesh, placements(spec, mesh))


def local_call(fn, mesh, in_specs, out_specs, *args,
               partial_grads: bool = True):
    """``fn`` on each rank's shards, through ``local_map``: every tensor
    argument (a plain tensor taken as replicated) is redistributed to
    its spec in ``in_specs`` (``None``: the argument passes as it is)
    and ``fn``'s local results become DTensors placed by ``out_specs``
    (a spec, or a list of specs for a tuple of results).  Specs here
    are full length, one entry per tensor dim.

    Gradients: an argument replicated over a mesh axis that shards a
    result is used by each rank of that axis for its own slice of the
    work, so its local gradients are partial sums (``Partial``) there
    and DTensor adds them up.  ``partial_grads=False`` leaves every
    gradient placed as its argument, for a body that sums them itself
    (``copy_to``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    # local_map reads a tuple as one entry per result, a list as the
    # placements of one result
    if isinstance(out_specs, list):
        outs = [list(placements(s, mesh)) for s in out_specs]
        out_pl = tuple(outs)
    else:
        outs = [list(placements(out_specs, mesh))]
        out_pl = outs[0]
    split = [any(isinstance(o[m], Shard) for o in outs)
             for m in range(mesh.ndim)]
    ins, in_pl, grad_pl = [], [], []
    for a, spec in zip(args, in_specs):
        if spec is None or not isinstance(a, torch.Tensor):
            ins.append(a)
            in_pl.append(None)
            grad_pl.append(None)
            continue
        spec = _fit_spec(spec, a.ndim, a.shape, mesh)
        pl = list(placements(spec, mesh))
        ins.append(as_dtensor(a, mesh))
        in_pl.append(pl)
        grad_pl.append([Partial() if partial_grads and split[m]
                        and isinstance(p, Replicate) else p
                        for m, p in enumerate(pl)])
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*ins)


def _axes_tuple(axes) -> tuple:
    return axes if isinstance(axes, tuple) else (axes,)


_GROUPS: dict = {}


def group_of(mesh, axes):
    """The process group of the mesh axes ``axes`` (a name or a tuple of
    names) as the functional collectives take it: ``(mesh, dim)`` for
    one axis, a flattened sub-mesh for a tuple (its first axis major)."""
    axes = tuple(a for a in _axes_tuple(axes) if a in axis_names(mesh))
    if len(axes) == 1:
        return (mesh, axis_names(mesh).index(axes[0]))
    key = (mesh, axes)
    if key not in _GROUPS:
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        # the sub-mesh indexes the mesh's own rank tensor, which a fake
        # mode (the dry run's) must not take over
        with unset_fake_temporarily():
            _GROUPS[key] = mesh[axes]._flatten("_".join(axes))
    return _GROUPS[key]


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (a tuple flattened, its first
    axis major): the reference's ``lax.axis_index``."""
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    idx = 0
    for a in _axes_tuple(axes):
        if a in coord:
            idx = idx * sizes[a] + coord[a]
    return idx


def axis_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return _prod(sizes, [a for a in _axes_tuple(axes) if a in sizes])


def _wait(t):
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


class _PSum(torch.autograd.Function):
    """Sum over a group; the backward passes the cotangent through, as
    every rank of the group holds the same cotangent of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        return _wait(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``; the backward sums the cotangents
    over the group and keeps this rank's tile (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        from torch.distributed import _functional_collectives as funcol
        ctx.dim, ctx.group = dim, group
        gather = getattr(funcol, "all_gather_single", None) \
            or funcol.all_gather_tensor
        out = gather(x.movedim(dim, 0).contiguous(), 0, group)
        return _wait(out).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        out = funcol.reduce_scatter_tensor(
            g.movedim(ctx.dim, 0).contiguous(), "sum", 0, ctx.group)
        return _wait(out).movedim(0, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the cotangents over a group:
    a replicated input that each rank of the group uses for its own
    share of the work (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return _wait(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to(x, mesh, axes):
    """``x`` as it is; its gradient summed over ``axes`` in the backward
    (inside a per-rank body, where every rank of ``axes`` holds ``x``
    whole and adds its own part of the gradient)."""
    axes = tuple(a for a in _axes_tuple(axes) if axis_size(mesh, a) > 1)
    if not axes:
        return x
    return _CopyTo.apply(x, group_of(mesh, axes))


def scale_grad(x, scale: float):
    """``x`` as it is; its gradient times ``scale`` in the backward."""
    return _ScaleGrad.apply(x, scale)


def psum(x, mesh, axes):
    """``lax.psum`` over ``axes`` inside a per-rank body."""
    if axis_size(mesh, axes) == 1:
        return x
    return _PSum.apply(x, group_of(mesh, axes))


def pmax(x, mesh, axes):
    """``lax.pmax`` over ``axes`` inside a per-rank body (no gradient)."""
    from torch.distributed import _functional_collectives as funcol

    if axis_size(mesh, axes) == 1:
        return x
    return _wait(funcol.all_reduce(x.contiguous(), "max",
                                   group_of(mesh, axes)))


def pmean(x, mesh, axes):
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def all_gather(x, mesh, axes, dim: int):
    """``lax.all_gather(..., axis=dim, tiled=True)`` over ``axes``."""
    if axis_size(mesh, axes) == 1:
        return x
    return _AllGather.apply(x, dim, group_of(mesh, axes))


def unshard_dim(x, dim: int):
    """A DTensor with no mesh axis sharding tensor dim ``dim`` (gathered
    there); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


@torch.no_grad()
def write_rows(buf, dim: int, slots, rows) -> None:
    """``buf`` along ``dim`` at the integer ``slots`` (1-D) set to
    ``rows`` (``index_copy_``), in place.  On a DTensor each rank writes
    the rows that fall in its own shard of ``buf``, on its local tensor:
    the rows are gathered along ``dim`` first and every other dim placed
    as ``buf``'s, so no rank reads another's shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(buf, DTensor):
        buf.index_copy_(dim, slots, rows.to(buf.dtype))
        return
    mesh = buf.device_mesh
    rows = as_dtensor(rows, mesh)
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in buf.placements]
    local_rows = rows.redistribute(mesh, pl).to_local().to(buf.dtype)
    slots = (slots.full_tensor() if isinstance(slots, DTensor) else slots)
    local = buf.to_local()
    n_local = local.shape[dim]
    off = 0
    coord = mesh.get_coordinate()
    for m, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == dim:
            off = off * mesh.size(m) + coord[m]
    off *= n_local
    rel = slots.long() - off
    inside = (rel >= 0) & (rel < n_local)
    safe = torch.clamp(rel, 0, n_local - 1)
    # the slots outside this shard land on a clamped row too; every entry
    # that lands on one row gets that row's one value (the inside entry's
    # if there is one, else the row's own), so the order in which
    # ``index_copy_`` writes repeated rows does not matter
    order = torch.arange(slots.numel(), device=local.device)
    winner = torch.full((n_local,), -1, dtype=torch.long,
                        device=local.device).scatter_reduce(
        0, safe, torch.where(inside, order, -1), "amax")[safe]
    shape = [1] * local.ndim
    shape[dim] = -1
    local.index_copy_(dim, safe, torch.where(
        (winner >= 0).view(shape),
        local_rows.index_select(dim, winner.clamp(min=0)),
        local.index_select(dim, safe)))


def dp_axes(mesh) -> tuple:
    """The mesh's data-parallel axes, ``("pod", "data")`` as present."""
    return tuple(a for a in FSDP if a in axis_names(mesh))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)



def fit_dim(x, dim: int, n: int):
    """``x`` with tensor dim ``dim`` gathered when the mesh axes that
    shard it do not divide ``n`` (a DTensor about to be split into ``n``
    groups along it); a plain tensor as it is."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(x):
        return x
    dim %= x.ndim
    k = 1
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            k *= x.device_mesh.size(m)
    return unshard_dim(x, dim) if n % k else x


def split_last(x, *dims):
    """``x`` (..., prod(dims)) reshaped to (..., *dims).  A DTensor whose
    last dim is sharded over more ranks than ``dims[0]`` divides (9
    heads over a 16-wide ``model`` axis) is gathered along it first, as
    GSPMD reshards such a reshape."""
    x = fit_dim(x, -1, dims[0])
    return x.reshape(*x.shape[:-1], *dims)


@contextlib.contextmanager
def mesh_scope(mesh):
    """The context a step runs in under ``mesh``: plain tensors that meet
    DTensors (positions, masks, constants) are taken as replicated
    (DTensor's implicit replication; the flag it had is restored on
    exit, so scopes nest).  Nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before
