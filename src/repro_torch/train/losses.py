"""Cross-entropy (+ MoE aux + DeepSeek MTP) losses.

Counterpart of ``repro.train.losses``, term for term: the mask keeps a
label that is not ``IGNORE`` and lies below ``vocab_size``; the
log-sum-exp runs in f32 over the whole padded vocabulary (the pad
columns stay in the normaliser, as in the reference).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import _head
from repro_torch.models import sharding as sh
from repro_torch.models.common import rms_norm

IGNORE = -100


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean CE over non-ignored labels.  logits: (B,S,Vpad), labels: (B,S).
    DTensor logits sharded over the vocabulary are gathered along it
    first (the gold logit is one column)."""
    logits = sh.unshard_dim(logits, -1)
    mask = (labels != IGNORE) & (labels < vocab_size)
    safe = torch.where(mask, labels, 0).long()
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, safe[..., None])[..., 0]
    ce = (lse - gold) * mask
    return ce.sum() / torch.clamp(mask.sum(), min=1)


def next_token_labels(tokens: torch.Tensor) -> torch.Tensor:
    """Shift-left labels with the final position ignored."""
    return torch.cat([tokens[:, 1:], torch.full(
        (tokens.shape[0], 1), IGNORE, dtype=tokens.dtype,
        device=tokens.device)], dim=1)


def train_loss(model, params, batch: dict, cfg: ModelConfig,
               mtp_weight: float = 0.1):
    """Total loss = CE + aux_coef * moe_aux (+ mtp_weight * MTP CE).
    Returns ``(total, {"ce", "aux"[, "mtp_ce"]})``, 0-dim f32 tensors."""
    labels = batch.get("labels")
    if labels is None:
        labels = next_token_labels(batch["tokens"])
    if cfg.mtp_depth:
        hidden, aux = model.forward_hidden(params, batch)
        h = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        # placed as ``forward`` places its logits
        logits = sh.constrain(_head(params, cfg, h), model.mesh,
                              (sh.FSDP, None, "model"))
    else:
        logits, aux = model.forward(params, batch)
    if cfg.num_patch_tokens:
        # logits cover [patches, text]; only text positions carry labels
        logits = logits[:, -batch["tokens"].shape[1]:]
    ce = softmax_xent(logits, labels, cfg.vocab_size)
    total = ce + cfg.moe_aux_loss_coef * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth:
        # depth-1 MTP: logits2[t] predicts token t+2
        logits2, aux2 = model.mtp_logits(params, hidden, batch["tokens"])
        lab2 = labels[:, 1:]
        mtp_ce = softmax_xent(logits2, lab2, cfg.vocab_size)
        total = total + mtp_weight * mtp_ce + cfg.moe_aux_loss_coef * aux2
        metrics["mtp_ce"] = mtp_ce
    return total, metrics
