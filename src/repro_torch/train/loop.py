"""Training step and host loop.

Counterpart of ``repro.train.loop``.  The step takes
the gradient of ``train_loss`` with ``torch.autograd.grad`` (a leaf the
loss does not reach, such as a router bias that only steers the top-k,
gets a zero gradient, as ``jax.grad`` gives it) and runs
``adamw_update``, which writes the new parameters and moments over the
state's in place: the counterpart of the reference's
``jax.jit(step, donate_argnums=(0,))``.  The loop reads the metrics back
to the host only at its log steps, as the reference's ``float(v)``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.models import sharding as sh
from repro_torch.models.api import Model, _mesh_scope, _on_mesh
from repro_torch.train.losses import train_loss
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.utils.tree import tree_leaves, tree_map_with_path, tree_paths


@dataclass
class TrainState:
    params: Any
    opt: Any

    def as_dict(self):
        return {"params": self.params, "opt": self.opt}


def state_specs(params, mesh, fsdp: bool = True) -> dict:
    """Specs of ``{"params", "opt"}``: the parameters by
    ``sharding.param_specs``, the moments as their parameters, the step
    replicated (the reference dry run's)."""
    pspecs = sh.param_specs(params, mesh, fsdp=fsdp)
    return {"params": pspecs,
            "opt": {"mu": pspecs, "nu": pspecs, "step": ()}}


def init_state(model: Model, gen: torch.Generator, oc: OptConfig,
               mesh=None, fsdp: bool = True) -> TrainState:
    """Parameters drawn from ``gen`` and zero AdamW moments.  Under
    ``mesh`` (``model.mesh`` when None) every leaf is a DTensor placed
    by ``state_specs``; every rank draws the same whole tensors and keeps
    its own shards."""
    mesh = model.mesh if mesh is None else mesh
    params = model.init(gen)
    state = {"params": params, "opt": adamw_init(params, oc)}
    if mesh is not None:
        state = sh.distribute(state, state_specs(params, mesh, fsdp), mesh)
    return TrainState(params=state["params"], opt=state["opt"])


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device``.  Host arrays go to a
    card through pinned memory without a synchronise, so that placing
    the next batch does not wait for the card to finish the step
    before it."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if sh.is_dtensor(v):
            out[k] = v
            continue
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def make_train_step(model: Model, oc: OptConfig) -> Callable:
    """``step(state, batch) -> (state, metrics)``: ``state`` is
    ``{"params", "opt"}`` (updated in place and returned), ``batch`` a
    ``make_batch`` dict of arrays or tensors (moved to the model's
    device).  Under ``model.mesh`` the state is ``init_state``'s
    DTensors, the batch is placed by ``sharding.batch_specs`` and the
    metrics are replicated DTensors.  The metrics are 0-dim device tensors: ``loss``, ``ce``,
    ``aux``, [``mtp_ce``], ``grad_norm`` and ``lr``."""
    cfg = model.cfg

    def step(state: dict, batch: dict):
        with _mesh_scope(model.mesh):
            return _step(state, _on_mesh(to_device(batch, model.device),
                                         model.mesh))

    def _step(state: dict, batch: dict):
        params = state["params"]
        live = {path: p.detach().requires_grad_()
                for path, p in zip(tree_paths(params), tree_leaves(params))}
        loss, metrics = train_loss(
            model, tree_map_with_path(lambda path, _: live[path], params),
            batch, cfg)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        grad_of = {path: torch.zeros_like(p) if g is None else g
                   for (path, p), g in zip(live.items(), grads)}
        new_params, new_opt, opt_metrics = adamw_update(
            params, tree_map_with_path(lambda path, _: grad_of[path], params),
            state["opt"], oc)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return {"params": new_params, "opt": new_opt}, metrics

    return step


def train_loop(model: Model, batches, oc: OptConfig,
               gen: Optional[torch.Generator] = None, log_every: int = 10,
               callback=None):
    """Simple host loop for the examples; returns final state + history.
    ``gen`` draws the initial parameters (``model.generator(0)`` when
    None)."""
    gen = gen if gen is not None else model.generator(0)
    state = init_state(model, gen, oc).as_dict()
    step_fn = make_train_step(model, oc)
    history = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or callback:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(m)
    return state, history
