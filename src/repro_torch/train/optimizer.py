"""AdamW in plain PyTorch.

Counterpart of ``repro.train.optimizer``, term for term: the warmup and
cosine schedule in f32 (``lr_at``), the clip by the global gradient
norm, bias corrections from an int32 step, weight decay on the leaves
the reference decays, moments in ``moment_dtype`` (f32 or bf16) and the
update computed in f32 and cast back to each leaf's dtype.

Two things follow from the port's layout and idiom:

* ``adamw_update`` writes the new parameters and moments over the old
  ones in place, under ``torch.no_grad()``: the counterpart of the
  reference's ``donate_argnums``.  The parameters and moment tensors
  passed in are the ones returned.
* The reference decays a leaf when its ``ndim >= 2``, and it stacks
  each layer group's leaves on a leading layer axis, so a per-layer norm
  scale (d,) is a decayed (L, d) leaf there.  The port keeps its layers
  unstacked (``params["layers"][i]``, ``params["encoder"]["layers"]``),
  so a leaf under those counts the layer axis the reference gives it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils.tree import leaves_with_path, tree_map_with_path

_STACKED = ("layers", "encoder/layers")


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" for the giants
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_at(step, oc: OptConfig) -> torch.Tensor:
    """The learning rate after ``step`` updates (an int or an int32
    tensor), a 0-dim f32 tensor on the step's device."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = oc.min_lr_frac + (1 - oc.min_lr_frac) * cos
    return oc.lr * warm * frac


def adamw_init(params, oc: OptConfig) -> dict:
    dt = torch.bfloat16 if oc.moment_dtype == "bfloat16" else torch.float32

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = next(leaves_with_path(params))[1].device
    return {"mu": tree_map_with_path(zeros, params),
            "nu": tree_map_with_path(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float()))
              for _, x in leaves_with_path(tree)]
    return torch.sqrt(sum(leaves))


def _ref_ndim(parts: tuple, x: torch.Tensor) -> int:
    """The leaf's ndim in the reference's layout (see the module
    docstring)."""
    path = "/".join(str(p) for p in parts)
    return x.ndim + any(path.startswith(s + "/") for s in _STACKED)


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, oc: OptConfig):
    """One AdamW step.  ``grads`` has the structure of ``params``.
    Returns ``(params, new_opt_state, {"grad_norm", "lr"})``; the
    parameters and moments are updated in place (the module
    docstring)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if oc.grad_clip > 0 else 1.0
    lr = lr_at(step, oc)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    grad_of = dict(leaves_with_path(grads))
    mu_of = dict(leaves_with_path(opt_state["mu"]))
    nu_of = dict(leaves_with_path(opt_state["nu"]))
    for parts, p in leaves_with_path(params):
        g, mu, nu = grad_of[parts], mu_of[parts], nu_of[parts]
        g = g.float() * scale
        mu_new = b1 * mu.float() + (1 - b1) * g
        nu_new = b2 * nu.float() + (1 - b2) * torch.square(g)
        mhat = mu_new / bc1
        vhat = nu_new / bc2
        delta = mhat / (torch.sqrt(vhat) + oc.eps)
        decay = oc.weight_decay if _ref_ndim(parts, p) >= 2 else 0.0
        p_new = p.float() * (1 - lr * decay) - lr * delta
        p.copy_(p_new)
        mu.copy_(mu_new)
        nu.copy_(nu_new)
    return (params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                     "step": step}, {"grad_norm": gnorm, "lr": lr})
