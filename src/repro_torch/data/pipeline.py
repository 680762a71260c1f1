"""Data pipeline: synthetic token streams (+ modality stubs).
Deterministic per (seed, step) so multi-host shards agree.

Counterpart of ``repro.data.pipeline``, draw for draw: the same NumPy
generator calls in the same order, so a batch is byte for byte the
reference's.  The synthetic generator produces a learnable distribution
(Zipfian unigram + short-range repetition structure) so the train
examples show a genuinely decreasing loss.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.train.losses import IGNORE


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish unigram draw, cheap and heavy-tailed."""
    u = rng.random(shape)
    ranks = np.floor(np.exp(u * np.log(vocab))).astype(np.int64)
    return np.clip(ranks - 1, 0, vocab - 1).astype(np.int32)


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
               with_labels: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    s_text = seq - cfg.num_patch_tokens if cfg.num_patch_tokens else seq
    toks = _zipf_tokens(rng, (batch, s_text), cfg.vocab_size)
    # inject copy structure: second half repeats the first half shifted
    half = s_text // 2
    toks[:, half:half * 2] = toks[:, :half]
    out = {"tokens": toks}
    if with_labels:
        labels = np.concatenate(
            [toks[:, 1:], np.full((batch, 1), IGNORE, np.int32)], axis=1)
        out["labels"] = labels
    if cfg.num_patch_tokens:
        p = cfg.num_patch_tokens
        out["prefix_embeds"] = rng.standard_normal(
            (batch, p, cfg.d_model)).astype(np.float32) * 0.02
        pos = np.arange(seq, dtype=np.int32)
        out["mrope_positions"] = np.broadcast_to(pos, (3, batch, seq)).copy()
        # patches: temporal id frozen at 0, h/w walk a sqrt(p) grid
        side = max(int(np.sqrt(p)), 1)
        hh = (np.arange(p) // side).astype(np.int32)
        ww = (np.arange(p) % side).astype(np.int32)
        out["mrope_positions"][0, :, :p] = 0
        out["mrope_positions"][1, :, :p] = hh
        out["mrope_positions"][2, :, :p] = ww
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32) * 0.02
    return out


def synthetic_batches(cfg: ModelConfig, batch: int, seq: int, steps: int,
                      seed: int = 0) -> Iterator[dict]:
    for i in range(steps):
        yield make_batch(cfg, batch, seq, seed * 100003 + i)

