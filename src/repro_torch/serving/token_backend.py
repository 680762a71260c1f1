"""Real-kernel autoregressive serving on the card: ``TokenTorchBackend``.

Counterpart of ``repro.serving.token_backend`` (``TokenJaxBackend``).  A
dispatched gang runs phase-aware:

* prefill runs the model's prompt pass through the Hopper prefill
  kernels (``cfg.use_pallas_prefill``): attention on ``swa_prefill``
  (full causal attention is the window = S case), the RWKV-6 WKV6
  recurrence on ``rwkv6_scan`` and the Mamba2 SSD recurrence on
  ``ssd_scan`` over the prompt, producing every request's first token
  *and* the gang cache;
* each decode step runs the single-token pass through the Hopper decode
  kernels (``cfg.use_pallas_decode``): attention on ``decode_attention``,
  ``rwkv6_scan`` or ``ssd_scan`` with T = 1, one token per running slot.

The gang cache's batch axis is the slot pool: for attention each slot
holds a request's KV cache (for deepseek-v3's MLA its latent and rope
keys, attended in plain PyTorch as in the reference; the MoE layers
route each step's tokens through the single-shard ``moe_fwd`` at a
capacity fixed by the step's static shape); for RWKV-6 its recurrent state (token
shifts and the f32 WKV state, a fixed size whatever the length); for
zamba2 its Mamba2 state (conv windows and the f32 SSD state, a fixed
size) and the shared attention block's KV, one ring buffer per
application.  The backend treats the cache as opaque; the model updates
it in place.
Requests leave between decode steps by masking (their slots keep
stepping as padding) and the gang ends when the longest stream
finishes.  The two step
tables are keyed by ``(c, b)`` like the reference's executable tables;
on one device every ``c`` shares the same computation, so vertical
scaling changes scheduling only.  Each ``b`` owns one static gang (its
cache, prompt buffer and token buffer on the device); on the card its
prefill and decode steps are captured as CUDA graphs at warm-up
(``serving/capture.py``), the counterpart of the reference's
``jax.jit`` per entry, and serving replays them.  ``calibrate_token_fns``
times both tables, waiting for the device before reading the clock, and
fits the ``TokenCostModel`` the solver plans on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import TokenCostModel
from repro_torch.core.scaler import TokenSpongeScaler
from repro_torch.core.slo import Request
from repro_torch.core.vertical import TimedExecutor, device_sync
from repro_torch.models import build_model
from repro_torch.models.api import resolve_device
from repro_torch.serving.api import ScenarioRunner, _PooledBackend
from repro_torch.serving.capture import CapturedStep, table_replays
from repro_torch.serving.scenarios import build_scenario
from repro_torch.serving.trace import ServeTrace, span


def _host(x) -> np.ndarray:
    """Token ids as a host numpy array of their own (a step's ids are its
    static buffer, which the next step overwrites)."""
    if isinstance(x, torch.Tensor):
        return x.to("cpu", copy=True).numpy()
    return np.asarray(x)


def build_token_step_fns(model, params, c_set: Sequence[int],
                         b_set: Sequence[int], prompt_len: int,
                         max_decode: int = 8,
                         capture: Optional[bool] = None):
    """Two step tables for phase-aware LLM serving.

    ``prefill_fns[(c, b)](tokens)`` maps (b, prompt_len) int32 prompts to
    ``(first_token (b,), gang_cache)``; ``decode_fns[(c, b)](cache, tok)``
    advances every slot one token and returns ``(next (b,), cache)``.
    An attention cache holds ``prompt_len + max_decode + 1`` positions
    per slot (a sliding window at most its window; an RWKV-6 or Mamba2
    state has no positions).  Every c shares one pair of functions per b
    (see the module docstring).

    Each b has one static gang on the model's device: a cache of batch b
    (``gang_cache`` is always this one), a prompt buffer and a token
    buffer (the ids returned are always this one).  The prefill zeroes
    the cache, fills it from the prompt and writes the first ids into
    the token buffer; a decode step reads its ids from there and writes
    the next ids back, so between steps the ids stay on the device as
    the next input (a ``tok`` that is the buffer itself is not copied).
    A new prefill of a b therefore ends the gang before it: a caller
    runs one gang of a b at a time to its end, as
    ``TokenTorchBackend.execute`` does, and copies the ids it keeps.
    Both steps are :class:`CapturedStep` entries: captured as CUDA
    graphs at their first call (:func:`warmup_token_fns`) when
    ``capture`` (the default on a CUDA device), eager otherwise.
    """
    cache_len = prompt_len + max_decode + 1
    vocab = model.cfg.vocab_size
    device = model.device

    def make(b):
        with torch.inference_mode():
            cache = model.init_cache(b, cache_len)
            tokens = torch.zeros((b, prompt_len), dtype=torch.int32,
                                 device=device)
            ids = torch.zeros((b,), dtype=torch.int32, device=device)

        def prefill_body():
            logits, _ = model.prefill(params, {"tokens": tokens},
                                      cache=cache)
            return ids.copy_(torch.argmax(logits[:, :vocab], dim=-1))

        def decode_body():
            lg, _ = model.decode_step(params, cache, ids[:, None])
            return ids.copy_(torch.argmax(lg[:, :vocab], dim=-1))

        pre = CapturedStep(prefill_body, (tokens,), capture)
        dec = CapturedStep(decode_body, (ids,), capture)

        def prefill_fn(prompts):
            return pre(prompts), cache

        def decode_fn(gang_cache, tok):
            if gang_cache is not cache:
                raise ValueError("a decode step continues the gang of its "
                                 "own table entry")
            return dec(tok), cache

        prefill_fn.step, decode_fn.step = pre, dec
        return prefill_fn, decode_fn

    prefill_fns, decode_fns = {}, {}
    for b in b_set:
        pf, df = make(b)
        for c in c_set:
            prefill_fns[(c, b)] = pf
            decode_fns[(c, b)] = df
    return prefill_fns, decode_fns


def pad_prompts(payloads: List[np.ndarray], b: int,
                prompt_len: int) -> np.ndarray:
    """Stack prompt-token payloads into the (b, prompt_len) bucket:
    each prompt is right-padded (zeros) or truncated to ``prompt_len``,
    the batch axis padded by repeating the last entry."""
    rows = []
    for p in payloads:
        p = np.zeros(prompt_len, np.int32) if p is None \
            else np.asarray(p, np.int32).ravel()[:prompt_len]
        if p.size < prompt_len:
            p = np.pad(p, (0, prompt_len - p.size))
        rows.append(p)
    rows += [rows[-1]] * (b - len(rows))
    return np.stack(rows)


def warmup_token_fns(prefill_fns: Dict, decode_fns: Dict,
                     prompt_len: int) -> None:
    """Run every distinct (c, b) entry of both tables once before serving:
    the deploy-time pass that makes the later resize in-place.  On the
    card this captures each entry's CUDA graph (one eager run, which
    builds the kernels, then the capture and a replay).  Entries sharing
    one function are run once, not once per c."""
    seen: set[int] = set()
    for (c, b), pf in prefill_fns.items():
        if id(pf) in seen:
            continue
        seen.add(id(pf))
        tokens = np.ones((b, prompt_len), np.int32)
        first, cache = pf(tokens)
        decode_fns[(c, b)](cache, first)
    device_sync()


def calibrate_token_fns(prefill_fns: Dict, decode_fns: Dict,
                        prompt_len: int, mean_prompt: float = 0.0,
                        mean_decode: float = 4.0) -> TokenCostModel:
    """Time both tables once per (c, b) and fit the token cost model.

    Prefill samples are (b·prompt_len tokens, c, wall); decode samples
    are (b slots, c, wall).  Each wall time ends when the device has
    finished (run :func:`warmup_token_fns` first).
    """
    pre_samples, dec_samples = [], []
    for (c, b), pf in prefill_fns.items():
        tokens = np.ones((b, prompt_len), np.int32)
        device_sync()
        t0 = time.perf_counter()
        first, cache = pf(tokens)
        device_sync()
        pre_samples.append((float(b * prompt_len), float(c),
                            time.perf_counter() - t0))
        t0 = time.perf_counter()
        decode_fns[(c, b)](cache, first)
        device_sync()
        dec_samples.append((float(b), float(c), time.perf_counter() - t0))
    return TokenCostModel.fit(
        pre_samples, dec_samples,
        mean_prompt=mean_prompt or float(prompt_len),
        mean_decode=mean_decode)


class TokenTorchBackend(_PooledBackend):
    """Continuous-batching execution over the Hopper-kernel step tables.

    See the module docstring for the execution model (phase-aware gangs
    over a slot pool of KV caches, recurrent states or both).  ``clock="measured"`` advances virtual
    time by the wall latency of each phase (device work included),
    ``"modeled"`` by the calibrated :class:`TokenCostModel` (the kernels
    still run and produce real tokens).  Per-request lifecycle
    (``first_token`` / ``finish`` / ``tbt_violations``) is written here;
    generated token ids are collected in ``generated[request.id]``.
    A gang runs in its table entry's static cache and id buffer
    (:func:`build_token_step_fns`); ``execute`` runs each gang to its
    end before it returns, so no prefill overwrites a live gang, and it
    copies each step's ids to the host.

    With a ``trace`` (``serving/trace.py``) each ``execute`` is the span
    ``sponge.gang`` (its id, ``c``, ``b`` and request ids); inside it the
    step calls are ``sponge.prefill`` / ``sponge.decode`` (each with its
    ``sponge.sync``), each copy of ids to the host is
    ``sponge.ids_to_host``, and each request's first and last token are
    marked ``sponge.first_token`` / ``sponge.finish``.
    """

    name = "token-torch"
    trace = None

    def __init__(self, prefill_fns: Dict[tuple[int, int], Callable],
                 decode_fns: Dict[tuple[int, int], Callable],
                 cost: TokenCostModel, prompt_len: int,
                 max_decode: int = 8, clock: str = "measured",
                 c0: Optional[int] = None, resize_penalty: float = 0.0):
        if clock not in ("measured", "modeled"):
            raise ValueError(f"clock must be 'measured' or 'modeled', "
                             f"got {clock!r}")
        self.pre_table = TimedExecutor(prefill_fns, "prefill")
        self.dec_table = TimedExecutor(decode_fns, "decode")
        self.cost = cost
        self.prompt_len = prompt_len
        self.max_decode = max_decode
        self.clock = clock
        self.generated: Dict[int, List[int]] = {}
        self.tokens_served = 0
        self._payloads: Dict[int, Any] = {}
        c_set = sorted({c for c, _ in prefill_fns})
        b_set = sorted({b for _, b in prefill_fns})
        super().__init__(cost, c_set, b_set, c0=c0 or max(c_set),
                         resize_penalty=resize_penalty)

    def warmup(self) -> None:
        """Run every (c, b) prefill + decode entry once (on the card:
        capture its CUDA graphs)."""
        warmup_token_fns(self.pre_table.fns, self.dec_table.fns,
                         self.prompt_len)

    def on_submit(self, req: Request, payload: Any) -> None:
        self._payloads[req.id] = payload

    def set_trace(self, trace: Optional[ServeTrace]) -> None:
        """Record into ``trace`` from now on (None: stop recording)."""
        self.trace = self.pre_table.trace = self.dec_table.trace = trace

    def execute(self, batch: List[Request], c: int, b: int,
                now: float) -> float:
        tr = self.trace
        if tr is None:
            return self._run_gang(batch, c, b, now, None)
        with tr.gang_span(c=c, b=b, reqs=[r.id for r in batch]):
            return self._run_gang(batch, c, b, now, tr)

    def _run_gang(self, batch: List[Request], c: int, b: int, now: float,
                  tr: Optional[ServeTrace]) -> float:
        tokens = pad_prompts([self._payloads.pop(r.id, None)
                              for r in batch], b, self.prompt_len)
        tok, cache = self.pre_table(c, b, tokens)
        if tr is not None:
            for r in batch:
                tr.mark("first_token", req=r.id, gang=tr.gang)
                if min(r.decode_tokens, self.max_decode) == 0:
                    tr.mark("finish", req=r.id, gang=tr.gang)
        with span(tr, "ids_to_host"):
            first = _host(tok)
        dt = self.pre_table.calls[-1][3]
        if self.clock == "modeled":
            total_prompt = sum(r.prompt_tokens for r in batch)
            dt = float(self.cost.prefill_latency(c, total_prompt))
        t = now + dt
        remaining = np.zeros(b, np.int64)
        for i, r in enumerate(batch):
            r.first_token = t
            self.generated[r.id] = [int(first[i])]
            self.tokens_served += 1
            remaining[i] = min(r.decode_tokens, self.max_decode)
            if remaining[i] == 0:
                r.finish = t
        while (remaining > 0).any():
            tok, cache = self.dec_table(c, b, cache, tok)
            if tr is not None:
                for i in np.flatnonzero(remaining == 1):
                    tr.mark("finish", req=batch[i].id, gang=tr.gang)
            with span(tr, "ids_to_host"):
                nxt = _host(tok)        # the ids stay on the device as input
            dt = self.dec_table.calls[-1][3]
            if self.clock == "modeled":
                dt = float(self.cost.decode_latency(
                    c, int((remaining > 0).sum())))
            t += dt
            for i, r in enumerate(batch):
                if remaining[i] <= 0:
                    continue            # slot already left the pool
                if dt > r.tbt_slo + 1e-12:
                    r.tbt_violations += 1
                self.generated[r.id].append(int(nxt[i]))
                self.tokens_served += 1
                remaining[i] -= 1
                if remaining[i] == 0:
                    r.finish = t
        return t


def make_token_live_server(arch="smollm-135m-reduced", *,
                           c_set: Sequence[int] = (1, 2, 4),
                           b_set: Sequence[int] = (1, 2, 4),
                           prompt_len: int = 16, max_decode: int = 8,
                           clock: str = "measured", tick: float = 0.5,
                           prior_rps: float = 0.0,
                           cost: Optional[TokenCostModel] = None,
                           params: Optional[dict] = None, seed: int = 0,
                           device=None, trace: Optional[ServeTrace] = None):
    """Build the full real-kernel token serving stack.

    Resolves ``arch`` through ``configs.registry`` (or takes it as it
    is when it is a ``ModelConfig``, e.g. a model cut in depth) with
    both Hopper kernel routes on, builds the model on ``device`` (``cuda`` unless
    named) with ``params`` (e.g. from ``params_from_jax``) or random
    weights drawn from ``seed``, builds and warms the two (c, b) step
    tables, calibrates a :class:`TokenCostModel` from them unless
    ``cost`` is given, and wires a ``TokenSpongeScaler`` +
    :class:`TokenTorchBackend` behind the ``ScenarioRunner``.  Returns
    ``(runner, backend, cfg, cost)``.  With a ``trace``
    (``serving/trace.py``) every captured step, both tables, the backend
    and the runner record into it, and the warm-up and the calibration
    are its spans ``sponge.setup.capture`` and ``sponge.setup.calibrate``.
    """
    base = arch if isinstance(arch, ModelConfig) else get_config(arch)
    cfg = dataclasses.replace(base, use_pallas_prefill=True,
                              use_pallas_decode=True)
    model = build_model(cfg, device=device)
    if params is None:
        params = model.init(model.generator(seed))
    prefill_fns, decode_fns = build_token_step_fns(
        model, params, c_set, b_set, prompt_len, max_decode=max_decode)
    if trace is not None:
        for fn in [*prefill_fns.values(), *decode_fns.values()]:
            fn.step.trace = trace
    with span(trace, "setup.capture"):
        warmup_token_fns(prefill_fns, decode_fns, prompt_len)
    if cost is None:
        with span(trace, "setup.calibrate"):
            cost = calibrate_token_fns(prefill_fns, decode_fns, prompt_len,
                                       mean_decode=max_decode / 2.0)
    scaler = TokenSpongeScaler(cost, c_set=tuple(c_set),
                               b_set=tuple(b_set),
                               adaptation_interval=tick)
    backend = TokenTorchBackend(prefill_fns, decode_fns, cost, prompt_len,
                                max_decode=max_decode, clock=clock)
    backend.set_trace(trace)
    runner = ScenarioRunner(scaler, backend, tick=tick)
    runner.trace = trace
    runner.monitor.rate.prior_rps = prior_rps
    return runner, backend, cfg, cost


def scenario_arrivals(batch, requests: int, seed: int, prompt_len: int,
                      max_decode: int, vocab_size: int):
    """``(Request, prompt)`` pairs for the first ``requests`` arrivals of
    a token workload: prompts truncated to the ``prompt_len`` bucket,
    decode streams clipped to ``max_decode``, prompt ids drawn from
    ``seed`` (the reference's ``run_token_jax_scenario`` draws them the
    same way)."""
    rng = np.random.default_rng(seed)
    arrivals = []
    for r in batch.head(requests).to_requests():
        r = Request.make(arrival=r.arrival, comm_latency=r.comm_latency,
                         slo=r.slo, size_kb=r.size_kb,
                         prompt_tokens=min(r.prompt_tokens, prompt_len),
                         decode_tokens=min(r.decode_tokens, max_decode),
                         tbt_slo=r.tbt_slo)
        prompt = rng.integers(0, vocab_size,
                              r.prompt_tokens).astype(np.int32)
        arrivals.append((r, prompt))
    return arrivals


def run_token_scenario(name: str, *, requests: int = 24, seed: int = 0,
                       arch="smollm-135m-reduced",
                       prompt_len: int = 16, max_decode: int = 8,
                       clock: str = "measured", rps: Optional[float] = None,
                       c_set: Sequence[int] = (1, 2, 4),
                       b_set: Sequence[int] = (1, 2, 4),
                       params: Optional[dict] = None, device=None):
    """Serve a slice of a registered token scenario on the real kernels.

    Materializes ``requests`` arrivals from the scenario's workload,
    serves them through :func:`make_token_live_server` (``arch`` a
    registry id or a ``ModelConfig``; tables over ``c_set`` x ``b_set``,
    with ``params`` or random weights) on
    ``device`` (``cuda`` unless named) and returns ``(RunReport,
    stats)``.
    """
    dev = resolve_device(device)
    batch, meta = build_scenario(name, requests=requests, seed=seed,
                                 rps=rps)
    if not meta.get("token"):
        raise ValueError(f"{name!r} is not a token scenario")
    runner, backend, cfg, cost = make_token_live_server(
        arch, c_set=c_set, b_set=b_set, prompt_len=prompt_len,
        max_decode=max_decode, clock=clock, prior_rps=meta["expected_rps"],
        tick=meta.get("tick", 0.5), params=params, device=dev)
    arrivals = scenario_arrivals(batch, requests, seed, prompt_len,
                                 max_decode, cfg.vocab_size)
    t0 = time.perf_counter()
    report = runner.run(arrivals)
    stats = {"engine": "token-torch", "arch": cfg.name,
             "device": str(dev),
             "events": runner.events_processed,
             "requests": len(arrivals),
             "run_wall_s": time.perf_counter() - t0,
             "tokens_executed": backend.tokens_served,
             "step_calls": (len(backend.pre_table.calls)
                            + len(backend.dec_table.calls)),
             "graph_replays": table_replays(backend.pre_table.fns,
                                            backend.dec_table.fns),
             "generated": backend.generated,
             "cost": cost, "cost_r2": (cost.r2_prefill, cost.r2_decode),
             "meta": meta}
    return report, stats
