"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample
of the finished requests, drawn from the run's seed and holding the
one with the most served tokens, is read again by the reference
(``perfbench/reference/<family>.py``, f32, TF32 off): each request's
sequence as the program was given it (its prompt right-padded with id
0 to the bucket, the program's documented padding) followed by the
tokens it served, one pass with no cache.  At the position of each
served token the reference's best logit minus the logit of the served
token is that token's gap.  A run is correct when every request sent in
the window was served in full (1 + its decode tokens) and the widest
gap of the sample is within the cell's limit
(``perfbench/cells/<cell>.json``); a sample with no token fails.

``gaps(..., control=True)`` also reads, at the same positions, the gap
of the token that the reference computed with fp8 operands puts first:
the control, which has to fail the limit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

SAMPLE_TOKENS = 256          # the sample holds at least this many tokens


def sample(run, generated: Dict[int, List[int]], seed: int,
           tokens: int = SAMPLE_TOKENS) -> List[int]:
    """Finished requests, the longest first, then in an order drawn from
    the seed, until they hold ``tokens`` served tokens."""
    done = sorted(generated)
    if not done:
        return []
    longest = max(done, key=lambda i: (len(generated[i]),
                                       run.reqs[i].prompt_tokens))
    rng = np.random.default_rng([int(seed), 0x5eed])
    order = [longest] + [int(i) for i in rng.permutation(done)
                         if i != longest]
    pick, n = [], 0
    for i in order:
        pick.append(i)
        n += len(generated[i])
        if n >= tokens:
            break
    return pick


def gaps(family, params, conf: dict, bucket: int, run, generated,
         pick: List[int], device, control: bool = False) -> dict:
    """Per-token gaps of the sample (module docstring); with ``control``
    also the fp8 reference's first choices' gaps."""
    import torch

    from perfbench.reference.common import strict_f32
    strict_f32()
    out = {"served": [], "control": []}
    for i in pick:
        prompt = torch.zeros(bucket, dtype=torch.long)
        p = run.reqs[i].prompt
        prompt[:p.size] = torch.from_numpy(p.astype(np.int64))
        served = torch.tensor(generated[i], dtype=torch.long)
        seq = torch.cat([prompt, served[:-1]]).to(device)
        rows = torch.arange(bucket - 1, bucket - 1 + served.numel(),
                            device=device)
        ref = family.logits(params, seq, rows, conf, "f32")
        best = ref.max(dim=-1).values
        take = served.to(device)[:, None]
        out["served"] += (best - ref.gather(1, take)[:, 0]).tolist()
        if control:
            low = family.logits(params, seq, rows, conf, "fp8")
            pick_low = low.argmax(dim=-1, keepdim=True)
            out["control"] += (best - ref.gather(1, pick_low)[:, 0]).tolist()
        del ref
    return out


def verdict(run, generated, gap_list: List[float], limits: dict) -> tuple:
    """(correct, numbers compared beside their limits)."""
    failed = sum(1 for r in run.reqs if r.index not in generated)
    wrong_len = sum(1 for r in run.reqs if r.index in generated
                    and len(generated[r.index]) != 1 + r.decode_tokens)
    widest = max(gap_list) if gap_list else None
    numbers = {
        "unfinished": {"value": failed, "limit": 0},
        "wrong_length": {"value": wrong_len, "limit": 0},
        "logit_gap": {"value": widest, "limit": limits["logit_gap"]},
    }
    ok = (failed == 0 and wrong_len == 0 and widest is not None
          and widest <= limits["logit_gap"])
    return ok, numbers
