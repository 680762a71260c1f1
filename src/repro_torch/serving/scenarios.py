"""Scenario registry, cut to the ``llm-chat`` and ``llm-mixed-len``
workloads.

Copy of ``repro.serving.scenarios``: ``Scenario``, the registry,
``poisson_times``, the token meta, the ``llm-chat`` and
``llm-mixed-len`` builders and ``build_scenario``.  The same seed gives the same ``RequestBatch`` as
the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import TokenCostModel
from repro_torch.network.latency import comm_latency_many
from repro_torch.network.traces import synth_4g_trace
from repro_torch.serving.workload import RequestBatch, lognormal_lengths


@dataclass(frozen=True)
class Scenario:
    """A named workload script.

    ``build(duration_s, rps, rng)`` returns ``(RequestBatch, meta)``;
    ``meta`` must carry ``slo`` (nominal, what SLO-blind policies like
    FA2 plan with) and ``expected_rps`` (deploy-time rate prior).
    ``mean_rate_factor`` maps the scenario's ``rps`` knob to its actual
    mean arrival rate, so ``requests=`` targets convert to a duration.
    """
    name: str
    summary: str
    build: Callable[[float, float, np.random.Generator],
                    Tuple[RequestBatch, dict]]
    default_rps: float
    default_duration: float
    mean_rate_factor: float = 1.0


SCENARIOS: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (returns it, decorator-style)."""
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    """Look up a registered scenario; KeyError lists what exists."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(SCENARIOS)}") from None


def list_scenarios() -> Dict[str, str]:
    """name -> one-line summary, for --help output and the docs check."""
    return {s.name: s.summary for s in SCENARIOS.values()}


def poisson_times(rate: float, duration: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson send times on [0, duration)."""
    n = rng.poisson(rate * duration)
    return np.sort(rng.uniform(0.0, duration, n))


def _trace_seconds(duration: float) -> int:
    return int(duration) + 5


def _token_meta(batch: RequestBatch, rps: float, trace, slo: float,
                tbt: float) -> dict:
    """Shared meta for token scenarios: the cost model's mean request
    shape is calibrated to the *generated* length distributions."""
    cost = TokenCostModel.smollm_like(
        mean_prompt=float(batch.prompt_tokens.mean()),
        mean_decode=float(batch.decode_tokens.mean()))
    return {"slo": slo, "expected_rps": rps, "trace": trace,
            "token": True, "cost": cost, "tbt": tbt, "tick": 0.25}


def _build_llm_chat(duration, rps, rng):
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    send = poisson_times(rps, duration, rng)
    n = send.size
    prompt = lognormal_lengths(rng, n, median=64, sigma=0.7, lo=8, hi=512)
    decode = lognormal_lengths(rng, n, median=24, sigma=0.6, lo=1, hi=128)
    # chat payloads are small: ~8 bytes per prompt token on the wire
    sizes = np.maximum(prompt * 0.008, 1.0)
    cl = comm_latency_many(sizes, trace, send)
    batch = RequestBatch.from_send(send, cl, slo=1.0, size_kb=sizes,
                                   prompt_tokens=prompt,
                                   decode_tokens=decode, tbt_slo=0.08)
    return batch, _token_meta(batch, rps, trace, slo=1.0, tbt=0.08)


register(Scenario(
    name="llm-chat",
    summary="autoregressive chat: log-normal prompt/decode lengths, "
            "1s TTFT + 80ms TBT SLOs, continuous batching",
    build=_build_llm_chat, default_rps=25.0, default_duration=600.0))


def _build_llm_mixed_len(duration, rps, rng):
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    send = poisson_times(rps, duration, rng)
    n = send.size
    is_doc = rng.uniform(0.0, 1.0, n) < 0.25
    prompt = np.where(
        is_doc,
        lognormal_lengths(rng, n, median=384, sigma=0.4, lo=128, hi=1024),
        lognormal_lengths(rng, n, median=48, sigma=0.5, lo=8, hi=256))
    decode = np.where(
        is_doc,
        lognormal_lengths(rng, n, median=48, sigma=0.5, lo=8, hi=192),
        lognormal_lengths(rng, n, median=16, sigma=0.5, lo=1, hi=64))
    slo = np.where(is_doc, 2.5, 0.8)            # TTFT budgets
    tbt = np.where(is_doc, 0.15, 0.06)          # per-token budgets
    sizes = np.maximum(prompt * 0.008, 1.0)
    cl = comm_latency_many(sizes, trace, send)
    batch = RequestBatch.from_send(send, cl, slo=slo, size_kb=sizes,
                                   prompt_tokens=prompt,
                                   decode_tokens=decode, tbt_slo=tbt)
    meta = _token_meta(batch, rps, trace, slo=0.8, tbt=0.06)
    return batch, meta


register(Scenario(
    name="llm-mixed-len",
    summary="chat + long-document mix (8x prompt spread, per-class "
            "TTFT/TBT SLOs) — batch composition varies wildly",
    build=_build_llm_mixed_len, default_rps=18.0, default_duration=600.0))


def build_scenario(name: str, *, duration: Optional[float] = None,
                   rps: Optional[float] = None, seed: int = 0,
                   requests: Optional[int] = None
                   ) -> Tuple[RequestBatch, dict]:
    """Materialize a registered scenario.  ``requests`` (if given)
    overrides ``duration`` with the window expected to produce that many
    arrivals at the scenario's mean rate — the million-request knob."""
    sc = get_scenario(name)
    rps = rps if rps is not None else sc.default_rps
    if requests is not None:
        duration = requests / (rps * sc.mean_rate_factor)
    duration = duration if duration is not None else sc.default_duration
    rng = np.random.default_rng(seed)
    batch, meta = sc.build(duration, rps, rng)
    meta.update(scenario=name, duration=duration, rps=rps, seed=seed)
    return batch, meta
