"""Scenario registry: named workload scripts and the scenario runner.

Copy of ``repro.serving.scenarios`` cut to the single-instance
scenarios.  Each scenario is a *vectorized* workload generator --
arrival pattern, network/dynamic-SLO model, request mix -- returning a
``RequestBatch`` plus the metadata policies need (nominal SLO, expected
rate); the same seed gives the same batch as the reference:

* ``steady``         -- fixed-rate arrivals over a 4G trace; the Fig. 4
  study continued to arbitrary scale.
* ``diurnal``        -- one compressed day: sinusoidal Poisson rate
  between ~25% and 100% of peak.
* ``flash-crowd``    -- low base load with two sudden arrival spikes
  beyond capacity; exercises the solver's infeasible fallback.
* ``network-replay`` -- fixed-rate arrivals, clients split across a 4G
  and a 5G bandwidth replay.
* ``mixed-slo``      -- three interleaved request classes with different
  SLOs and payload sizes.
* ``llm-chat`` / ``llm-mixed-len`` -- autoregressive token workloads
  (``meta["token"]``: TTFT + per-token SLOs, continuous batching).
* ``llm-heavy-tail`` / ``retrieve-then-generate`` -- token workloads
  whose decode lengths follow a declared distribution
  (``meta["decode_dist"]``, ``core.uncertainty``): quantile admission
  and speculative cancel-on-overrun.
* ``slo-renegotiation`` / ``cancel-storm`` -- online-session scenarios
  (``meta["session_events"]`` routes the run through the session API,
  ``serving.session``): network telemetry re-keys queued requests'
  deadlines mid-flight; overload spikes in which half the queued spike
  traffic cancels.

:func:`run_scenario` runs one on the struct-of-arrays fast engine (the
default: ``serving.fastpath`` and its column sessions, with the
quantized memo solver) or on the object-based exact engine
(``ScenarioRunner`` over ``SimBackend``, ``TokenSimBackend`` or a
session).  The reference's ``vector`` engine is not ported yet;
``token_backend.run_token_scenario`` serves a token scenario on the
card.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import TokenCostModel
from repro_torch.core.perf_model import PerfModel, yolov5s_like
from repro_torch.core.scaler import TokenSpongeScaler
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.core.uncertainty import (LognormalLengths, MixtureLengths,
                                          UncertaintyConfig)
from repro_torch.network.latency import comm_latency_many
from repro_torch.network.traces import synth_4g_trace, synth_5g_trace
from repro_torch.serving.api import (ScenarioRunner, TokenSimBackend,
                                     make_policy, make_sim_server)
from repro_torch.serving.fastpath import FastSimRunner, TokenFastSimRunner
from repro_torch.serving.session import drive_session_events
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


def inhomogeneous_poisson_times(rate_fn: Callable[[np.ndarray], np.ndarray],
                                rate_max: float, duration: float,
                                rng: np.random.Generator) -> np.ndarray:
    """Thinning: draw at ``rate_max``, keep each point w.p. rate(t)/max."""
    t = poisson_times(rate_max, duration, rng)
    keep = rng.uniform(0.0, 1.0, t.size) < rate_fn(t) / rate_max
    return t[keep]


def _trace_seconds(duration: float) -> int:
    return int(duration) + 5


def _build_steady(duration, rps, rng):
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    send = np.arange(0, duration, 1.0 / rps)
    cl = comm_latency_many(np.full(send.shape, 200.0), trace, send)
    batch = RequestBatch.from_send(send, cl, slo=1.0, size_kb=200.0)
    return batch, {"slo": 1.0, "expected_rps": rps, "trace": trace}


register(Scenario(
    name="steady",
    summary="fixed-rate arrivals over a 4G bandwidth replay (Fig. 4 at "
            "arbitrary scale)",
    build=_build_steady, default_rps=20.0, default_duration=600.0))


def _build_diurnal(duration, rps, rng):
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)

    def rate(t):
        # one compressed "day": trough ~25% of peak, peak at mid-window
        return rps * (0.25 + 0.75 * 0.5 * (1 - np.cos(2 * np.pi
                                                      * t / duration)))

    send = inhomogeneous_poisson_times(rate, rps, duration, rng)
    cl = comm_latency_many(np.full(send.shape, 200.0), trace, send)
    batch = RequestBatch.from_send(send, cl, slo=1.0, size_kb=200.0)
    return batch, {"slo": 1.0, "expected_rps": 0.625 * rps, "trace": trace,
                   "tick": 0.5}


register(Scenario(
    name="diurnal",
    summary="sinusoidal day/night Poisson load, trough 25% of peak — "
            "tests sustained scale-down without violations",
    build=_build_diurnal, default_rps=16.0, default_duration=600.0,
    mean_rate_factor=0.625))


def _build_flash_crowd(duration, rps, rng):
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    spikes = ((0.40, 0.02, 6.0), (0.70, 0.03, 3.0))   # (start, len, x-rate)

    def rate(t):
        r = np.full(t.shape, float(rps))
        for frac, width, mult in spikes:
            s = frac * duration
            r = np.where((t >= s) & (t < s + width * duration),
                         rps * mult, r)
        return r

    send = inhomogeneous_poisson_times(rate, rps * 6.0, duration, rng)
    cl = comm_latency_many(np.full(send.shape, 200.0), trace, send)
    batch = RequestBatch.from_send(send, cl, slo=1.0, size_kb=200.0)
    return batch, {"slo": 1.0, "expected_rps": rps, "trace": trace}


register(Scenario(
    name="flash-crowd",
    summary="low base load with two arrival spikes beyond cluster "
            "capacity — exercises the infeasible-fallback drain",
    build=_build_flash_crowd, default_rps=10.0, default_duration=600.0,
    mean_rate_factor=1.16))   # 1 + 0.02*(6-1) + 0.03*(3-1)


def _build_network_replay(duration, rps, rng):
    s4 = int(rng.integers(2**31))
    s5 = int(rng.integers(2**31))
    t4 = synth_4g_trace(_trace_seconds(duration), seed=s4)
    t5 = synth_5g_trace(_trace_seconds(duration), seed=s5)
    send = np.arange(0, duration, 1.0 / rps)
    on_5g = rng.uniform(0.0, 1.0, send.size) < 0.5
    sizes = np.full(send.shape, 200.0)
    cl = np.where(on_5g, comm_latency_many(sizes, t5, send),
                  comm_latency_many(sizes, t4, send))
    batch = RequestBatch.from_send(send, cl, slo=1.0, size_kb=sizes)
    return batch, {"slo": 1.0, "expected_rps": rps,
                   "trace": t4, "trace_5g": t5}


register(Scenario(
    name="network-replay",
    summary="fixed-rate clients split 50/50 across 4G and 5G bandwidth "
            "replays — the paper's dynamic-SLO squeeze, heterogeneous",
    build=_build_network_replay, default_rps=20.0,
    default_duration=600.0))


def _build_mixed_slo(duration, rps, rng):
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    send = poisson_times(rps, duration, rng)
    # class mix: (weight, slo, size_kb).  The interactive SLO sits close
    # to — but inside — the perf model's batch-latency floor, so EDF must
    # consistently front-run the tight class for the run to stay clean.
    classes = np.array([[0.20, 0.6, 50.0],
                        [0.55, 1.0, 200.0],
                        [0.25, 3.0, 800.0]])
    pick = rng.choice(3, size=send.size, p=classes[:, 0])
    slo = classes[pick, 1]
    sizes = classes[pick, 2]
    cl = comm_latency_many(sizes, trace, send)
    batch = RequestBatch.from_send(send, cl, slo=slo, size_kb=sizes)
    return batch, {"slo": float(classes[:, 1].min()),
                   "expected_rps": rps, "trace": trace,
                   "tick": 0.5}


register(Scenario(
    name="mixed-slo",
    summary="three interleaved SLO classes (0.6s/1s/3s, 50KB-800KB) — "
            "EDF + per-request budgets must prioritize the tight class",
    build=_build_mixed_slo, default_rps=12.0, default_duration=600.0))


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


def _build_llm_heavy_tail(duration, rps, rng):
    """Chat traffic whose decode lengths are *heavy-tailed* (Orloj's
    regime): the declared ``LognormalLengths`` is exactly the generating
    distribution, so the scheduler knows the distribution but not any
    request's realized length.  The tail above the p90 carries ~half the
    total decode mass — a deterministic-cost scaler planning at the mean
    lets a few monster streams hog every slot."""
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    send = poisson_times(rps, duration, rng)
    n = send.size
    prompt = lognormal_lengths(rng, n, median=64, sigma=0.7, lo=8, hi=512)
    decode = lognormal_lengths(rng, n, median=16, sigma=1.4, lo=1, hi=1024)
    sizes = np.maximum(prompt * 0.008, 1.0)
    cl = comm_latency_many(sizes, trace, send)
    dist = LognormalLengths(median=16, sigma=1.4, lo=1, hi=1024)
    batch = RequestBatch.from_send(send, cl, slo=1.0, size_kb=sizes,
                                   prompt_tokens=prompt,
                                   decode_tokens=decode, tbt_slo=0.08,
                                   decode_dist=dist)
    meta = _token_meta(batch, rps, trace, slo=1.0, tbt=0.08)
    meta["decode_dist"] = dist
    meta["admission_quantile"] = 0.9       # scenario default; CLI overrides
    return batch, meta


register(Scenario(
    name="llm-heavy-tail",
    summary="heavy-tailed decode lengths (lognormal sigma=1.4, declared "
            "distribution): quantile admission + cancel-on-overrun vs "
            "the deterministic-cost scaler",
    build=_build_llm_heavy_tail, default_rps=25.0, default_duration=600.0))


def _build_retrieve_then_generate(duration, rps, rng):
    """Vortex-style multi-stage requests under one end-to-end budget:
    ~35% of requests run a retrieval stage first (variable-duration,
    gamma-distributed, spent *before* the prompt reaches the server — it
    eats the TTFT budget exactly like slow networks do in the paper's
    dynamic-SLO mechanism) and then generate against a much longer
    retrieved context.  Decode lengths follow a two-component mixture
    the scheduler declares but cannot resolve per request."""
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    send = poisson_times(rps, duration, rng)
    n = send.size
    is_rag = rng.uniform(0.0, 1.0, n) < 0.35
    prompt = np.where(
        is_rag,
        lognormal_lengths(rng, n, median=320, sigma=0.5, lo=64, hi=1024),
        lognormal_lengths(rng, n, median=48, sigma=0.5, lo=8, hi=256))
    direct = LognormalLengths(median=16, sigma=0.6, lo=1, hi=128)
    rag = LognormalLengths(median=64, sigma=0.9, lo=8, hi=768)
    decode = np.where(is_rag,
                      rag.sample(rng, n).astype(np.int64),
                      direct.sample(rng, n).astype(np.int64))
    # the retrieval stage: gamma-distributed seconds added before the
    # request arrives at the generator (deadline = send + slo stands,
    # so retrieval time comes straight out of the TTFT budget)
    retrieval = np.where(is_rag, rng.gamma(2.0, 0.12, n), 0.0)
    sizes = np.maximum(prompt * 0.008, 1.0)
    cl = comm_latency_many(sizes, trace, send) + retrieval
    slo = np.where(is_rag, 2.0, 0.9)
    tbt = np.where(is_rag, 0.10, 0.07)
    dist = MixtureLengths((direct, rag), (0.65, 0.35))
    batch = RequestBatch.from_send(send, cl, slo=slo, size_kb=sizes,
                                   prompt_tokens=prompt,
                                   decode_tokens=decode, tbt_slo=tbt,
                                   decode_dist=dist)
    meta = _token_meta(batch, rps, trace, slo=0.9, tbt=0.07)
    meta["decode_dist"] = dist
    meta["admission_quantile"] = 0.9
    # tight class (direct, slo<=0.9) plans higher up the distribution
    meta["class_quantiles"] = ((1.0, 0.95),)
    return batch, meta


register(Scenario(
    name="retrieve-then-generate",
    summary="multi-stage RAG mix: variable-duration retrieval eats the "
            "TTFT budget, decode is a declared two-component mixture — "
            "per-SLO-class quantile admission",
    build=_build_retrieve_then_generate, default_rps=20.0,
    default_duration=600.0))


def _build_slo_renegotiation(duration, rps, rng):
    """Live telemetry renegotiates queued budgets as the network moves.

    Each request's deadline is provisioned at send time for the
    response-path latency the link then sustains; shortly after arrival
    a fraction of clients report fresh telemetry (``session_events``)
    and the deadline is re-keyed to ``send + slo - response_latency(t)``
    — a fade *tightens* a queued request's budget, a recovery *relaxes*
    it.  This is the paper's dynamic-SLO mechanism continued past
    submission, driven by the same 4G bandwidth replay."""
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    send = poisson_times(rps, duration, rng)
    sizes = np.full(send.shape, 200.0)
    cl = comm_latency_many(sizes, trace, send)
    batch = RequestBatch.from_send(send, cl, slo=1.0, size_kb=sizes)
    # provision the response leg (replies are ~4x smaller than request
    # payloads) at send-time bandwidth: the server must finish early
    # enough for the reply to make the end-to-end SLO
    resp_kb = batch.size_kb * 0.25
    resp0 = comm_latency_many(resp_kb, trace,
                              batch.arrival - batch.comm_latency)
    batch = dataclasses.replace(batch, deadline=batch.deadline - resp0)
    n = len(batch)
    pick = rng.uniform(0.0, 1.0, n) < 0.35
    t_ev = batch.arrival + rng.uniform(0.05, 0.45, n)
    resp1 = comm_latency_many(resp_kb, trace, t_ev)
    new_dl = (batch.arrival - batch.comm_latency) + batch.slo - resp1
    events = sorted(
        (float(t_ev[i]), "update", int(i), float(new_dl[i]))
        for i in np.flatnonzero(pick))
    return batch, {"slo": 1.0, "expected_rps": rps, "trace": trace,
                   "session_events": tuple(events), "tick": 0.5}


register(Scenario(
    name="slo-renegotiation",
    summary="network telemetry re-keys queued requests' budgets "
            "mid-flight (35% of clients; fades tighten, recoveries "
            "relax) — the online session API's headline scenario",
    build=_build_slo_renegotiation, default_rps=20.0,
    default_duration=600.0))


def _build_cancel_storm(duration, rps, rng):
    """Overload spikes where clients abandon queued requests en masse.

    Two arrival spikes push the queue past capacity; half the requests
    sent inside a spike cancel shortly after arriving (users giving up
    during the overload).  The cancel-aware λ window must deflate the
    provisioning signal immediately and the EDF queues must excise the
    cancelled entries without stalling dispatch."""
    seed = int(rng.integers(2**31))
    trace = synth_4g_trace(_trace_seconds(duration), seed=seed)
    spikes = ((0.35, 0.04, 4.0), (0.65, 0.03, 4.0))   # (start, len, x-rate)

    def rate(t):
        r = np.full(t.shape, float(rps))
        for frac, width, mult in spikes:
            s = frac * duration
            r = np.where((t >= s) & (t < s + width * duration),
                         rps * mult, r)
        return r

    send = inhomogeneous_poisson_times(rate, rps * 4.0, duration, rng)
    cl = comm_latency_many(np.full(send.shape, 200.0), trace, send)
    batch = RequestBatch.from_send(send, cl, slo=1.0, size_kb=200.0)
    n = len(batch)
    src_send = batch.arrival - batch.comm_latency
    in_spike = np.zeros(n, bool)
    for frac, width, _ in spikes:
        s = frac * duration
        in_spike |= (src_send >= s) & (src_send < s + width * duration)
    pick = in_spike & (rng.uniform(0.0, 1.0, n) < 0.5)
    t_ev = batch.arrival + rng.uniform(0.1, 0.6, n)
    events = sorted((float(t_ev[i]), "cancel", int(i))
                    for i in np.flatnonzero(pick))
    return batch, {"slo": 1.0, "expected_rps": rps, "trace": trace,
                   "session_events": tuple(events), "tick": 0.5}


register(Scenario(
    name="cancel-storm",
    summary="4x overload spikes where half the spike traffic cancels "
            "while queued — exercises EDF excision + cancel-aware λ",
    build=_build_cancel_storm, default_rps=15.0, default_duration=600.0,
    mean_rate_factor=1.21))   # 1 + 0.04*(4-1) + 0.03*(4-1)


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


ENGINES = ("fast", "exact")


def check_engine(engine: str) -> None:
    """Refuse an engine the port does not run, naming what it runs."""
    if engine not in ENGINES:
        raise ValueError(
            f"engine={engine!r} is not ported: the port runs "
            "engine='fast' (the struct-of-arrays engines, the default) "
            "and engine='exact'; the vector engine comes with ROADMAP.md "
            "Queue 1 item 6c, and token_backend.run_token_scenario "
            "serves a token scenario on the card")


def run_scenario(name: str, *, policy: str = "sponge",
                 engine: str = "fast", duration: Optional[float] = None,
                 rps: Optional[float] = None, seed: int = 0,
                 requests: Optional[int] = None,
                 perf: Optional[PerfModel] = None,
                 c_set=DEFAULT_C, b_set=DEFAULT_B, c0: int = 16,
                 tick: Optional[float] = None,
                 horizon: Optional[float] = None,
                 budget_quantum: float = 0.01, lam_quantum: float = 0.5,
                 mid_flight: bool = True,
                 admission_quantile: Optional[float] = None,
                 speculative: bool = True,
                 **policy_kw):
    """Run a registered scenario end to end; returns ``(RunReport,
    stats)`` where ``stats`` carries engine/meta/solver-cache info.

    The fast engine (the default) pairs ``FastSimRunner`` with the
    memoized solver (quantized as given: ``budget_quantum`` /
    ``lam_quantum``, quanta 0 make it exact); the exact engine goes
    through ``make_sim_server`` with the paper's bruteforce solver
    (``policy_kw`` reaches the policy either way, e.g.
    ``resize_penalty`` or a policy's own options).  ``stats["solver"]``
    reports the memo solver's hits and misses.  Session scenarios
    (``meta["session_events"]``: ``slo-renegotiation``,
    ``cancel-storm``) run through the online session API on either
    engine; ``mid_flight=False`` suppresses the event stream -- the
    no-renegotiation replay of the same workload, the baseline the
    decision-stream delta is measured against.  Token scenarios run
    ``TokenSpongeScaler`` over ``TokenFastSimRunner`` (fast) or
    ``TokenSimBackend`` (exact, quanta 0); those that declare a
    decode-length distribution (``meta["decode_dist"]``:
    ``llm-heavy-tail``, ``retrieve-then-generate``) run
    distribution-aware admission: ``admission_quantile`` overrides the
    scenario's planning quantile (``0.0`` disables it -- the
    deterministic-cost baseline; ``None`` takes the scenario default),
    ``speculative=False`` turns off over-admission with
    cancel-on-overrun while keeping quantile drag.

    ``engine`` is ``"fast"`` or ``"exact"``; the reference's
    ``"vector"`` engine is not ported yet (ROADMAP.md Queue 1 item 6c)
    and raises ``ValueError``, as does any other name.  ``sponge-pred``
    inspects ``Request`` objects and runs on the exact engine only.
    """
    check_engine(engine)
    perf = perf if perf is not None else yolov5s_like()
    batch, meta = build_scenario(name, duration=duration, rps=rps,
                                 seed=seed, requests=requests)
    # a scenario with sub-second SLOs recommends its adaptation cadence
    tick = tick if tick is not None else meta.get("tick", 1.0)
    if admission_quantile is not None and not meta.get("token"):
        raise ValueError(
            "admission_quantile applies to token scenarios only "
            f"(scenario {name!r} is not token-based)")
    if meta.get("token"):
        return _run_token_scenario(batch, meta, policy=policy,
                                   engine=engine, c_set=c_set, b_set=b_set,
                                   c0=c0, tick=tick, horizon=horizon,
                                   budget_quantum=budget_quantum,
                                   lam_quantum=lam_quantum,
                                   admission_quantile=admission_quantile,
                                   speculative=speculative, **policy_kw)
    if meta.get("session_events") is not None:
        return _run_session_scenario(batch, meta, policy=policy,
                                     engine=engine, perf=perf,
                                     c_set=c_set, b_set=b_set, c0=c0,
                                     tick=tick, horizon=horizon,
                                     budget_quantum=budget_quantum,
                                     lam_quantum=lam_quantum,
                                     mid_flight=mid_flight, **policy_kw)
    common = dict(slo=meta["slo"], expected_rps=meta["expected_rps"],
                  adaptation_interval=tick)
    if engine == "fast":
        if policy.startswith("sponge-pred"):
            raise ValueError("sponge-pred inspects Request objects; "
                             "run it with engine='exact'")
        kw = dict(common, **policy_kw)
        if policy == "sponge":
            kw.update(solver="memo", budget_quantum=budget_quantum,
                      lam_quantum=lam_quantum)
        pol = make_policy(policy, perf, c_set=c_set, b_set=b_set, **kw)
        runner = FastSimRunner(pol, perf, c_set, b_set, c0=c0, tick=tick,
                               prior_rps=meta["expected_rps"])
        t0 = time.perf_counter()
        report = runner.run(batch, horizon)
        stats = {"engine": engine, "events": runner.events_processed,
                 "run_wall_s": time.perf_counter() - t0, "meta": meta}
        scaler = getattr(pol, "scaler", None)
        if scaler is not None and hasattr(scaler, "solver_stats"):
            stats["solver"] = scaler.solver_stats()
        return report, stats
    server = make_sim_server(perf, policy, c_set=c_set, b_set=b_set,
                             c0=c0, tick=tick,
                             prior_rps=meta["expected_rps"],
                             **dict(common, **policy_kw))
    reqs = batch.to_requests()
    t0 = time.perf_counter()
    report = server.run(reqs, horizon)
    return report, {"engine": "exact",
                    "events": server.runner.events_processed,
                    "run_wall_s": time.perf_counter() - t0,
                    "meta": meta}


def _run_session_scenario(batch: RequestBatch, meta: dict, *, policy: str,
                          engine: str, perf: PerfModel, c_set, b_set,
                          c0: int, tick: float, horizon,
                          budget_quantum: float, lam_quantum: float,
                          mid_flight: bool = True, **policy_kw):
    """Session-scenario execution: the online serving API end to end.

    The workload is submitted through a live session and the scenario's
    ``session_events`` stream (mid-flight ``update_slo`` / ``cancel``
    ops, time-sorted) is applied between ``step_until`` advances --
    how a network-telemetry feed would drive a real deployment.
    ``engine="fast"`` opens the session on a ``FastSimRunner`` (the
    ≥100k-request path); ``engine="exact"`` on ``make_sim_server``'s
    object-based runner.  ``mid_flight=False`` replays submits only
    (the closed-world baseline).  ``stats["session"]`` reports
    applied/no-op counts.
    """
    events = meta.get("session_events", ()) if mid_flight else ()
    common = dict(slo=meta["slo"], expected_rps=meta["expected_rps"],
                  adaptation_interval=tick)
    scaler = None
    if engine == "fast":
        if policy.startswith("sponge-pred"):
            raise ValueError("sponge-pred inspects Request objects; "
                             "run it with engine='exact'")
        kw = dict(common, **policy_kw)
        if policy == "sponge":
            kw.update(solver="memo", budget_quantum=budget_quantum,
                      lam_quantum=lam_quantum)
        pol = make_policy(policy, perf, c_set=c_set, b_set=b_set, **kw)
        runner = FastSimRunner(pol, perf, c_set, b_set, c0=c0, tick=tick,
                               prior_rps=meta["expected_rps"])
        sess = runner.session()
        scaler = getattr(pol, "scaler", None)
    else:
        server = make_sim_server(perf, policy, c_set=c_set, b_set=b_set,
                                 c0=c0, tick=tick,
                                 prior_rps=meta["expected_rps"],
                                 **dict(common, **policy_kw))
        sess = server.session()
    t0 = time.perf_counter()
    handles = sess.submit_batch(batch)
    applied = drive_session_events(sess, handles, events)
    report = sess.finish(horizon)
    stats = {"engine": engine, "events": sess.events_processed,
             "run_wall_s": time.perf_counter() - t0, "meta": meta,
             "session": applied}
    if scaler is not None and hasattr(scaler, "solver_stats"):
        stats["solver"] = scaler.solver_stats()
    return report, stats


def _token_uncertainty(meta: dict, admission_quantile: Optional[float],
                       speculative: bool):
    """Build the run's shared ``UncertaintyConfig`` (or ``None``).

    One instance is shared by the scaler and the engine so the online
    predictor's calibration error feeds back into the solver's slack.
    ``admission_quantile=None`` takes the scenario default
    (``meta["admission_quantile"]``); ``0.0`` disables the uncertainty
    path entirely -- the deterministic-cost baseline.  Scenarios without
    a declared ``decode_dist`` always run deterministic.
    """
    dist = meta.get("decode_dist")
    if dist is None:
        return None
    q = admission_quantile
    if q is None:
        q = meta.get("admission_quantile", 0.9)
    if q == 0.0:
        return None
    if not 0.0 < q < 1.0:
        raise ValueError("admission_quantile must be in [0, 1) "
                         f"(0 disables), got {q}")
    return UncertaintyConfig(dist=dist, admission_quantile=q,
                             class_quantiles=meta.get("class_quantiles", ()),
                             speculative=speculative)


def _run_token_scenario(batch: RequestBatch, meta: dict, *, policy: str,
                        c_set, b_set, c0: int, tick: float, horizon,
                        engine: str = "fast", budget_quantum: float = 0.01,
                        lam_quantum: float = 0.5, token_quantum: int = 16,
                        admission_quantile: Optional[float] = None,
                        speculative: bool = True, **policy_kw):
    """Token-scenario execution: the continuous-batching engines.

    ``engine="fast"`` -- ``fastpath.TokenFastSimRunner`` (struct-of-arrays
    decode streams, the >=100k-request path) with the quantized
    ``TokenMemoizedSolver``; ``engine="exact"`` -- the object-based
    ``ScenarioRunner`` over a gang-scheduled ``TokenSimBackend``, with
    the scaler's quanta set to 0.  Only the ``sponge`` policy
    understands token compositions; ``token_backend.run_token_scenario``
    serves the real kernels.

    When the scenario declares a decode-length distribution a fresh
    ``UncertaintyConfig`` is built per run (shared between scaler and
    engine -- the calibration feedback loop) and its summary lands in
    ``stats["uncertainty"]``.
    """
    if policy != "sponge":
        raise ValueError(
            f"token scenarios run the sponge policy only (got {policy!r}); "
            "fixed-work baselines cannot see token compositions")
    cost: TokenCostModel = meta["cost"]
    unc = _token_uncertainty(meta, admission_quantile, speculative)
    scaler = TokenSpongeScaler(
        cost, c_set=tuple(c_set), b_set=tuple(b_set),
        adaptation_interval=tick, budget_quantum=budget_quantum,
        lam_quantum=lam_quantum, token_quantum=token_quantum,
        uncertainty=unc, **policy_kw)
    if engine == "fast":
        runner = TokenFastSimRunner(scaler, cost, c_set, b_set, c0=c0,
                                    tick=tick,
                                    prior_rps=meta["expected_rps"],
                                    uncertainty=unc)
        t0 = time.perf_counter()
        report = runner.run(batch, horizon)
        stats = {"engine": "fast", "events": runner.events_processed,
                 "run_wall_s": time.perf_counter() - t0, "meta": meta,
                 "solver": scaler.solver_stats()}
        if unc is not None:
            stats["uncertainty"] = dict(
                unc.stats(), overrun_cancels=runner.overrun_cancels)
        return report, stats
    scaler.budget_quantum = 0.0
    scaler.lam_quantum = 0.0
    scaler.token_quantum = 0
    backend = TokenSimBackend(cost, c_set, b_set, c0=c0, uncertainty=unc)
    runner = ScenarioRunner(scaler, backend, tick=tick)
    runner.monitor.rate.prior_rps = meta["expected_rps"]
    reqs = batch.to_requests()
    t0 = time.perf_counter()
    report = runner.run(reqs, horizon)
    stats = {"engine": "exact", "events": runner.events_processed,
             "run_wall_s": time.perf_counter() - t0, "meta": meta}
    if unc is not None:
        stats["uncertainty"] = dict(
            unc.stats(), overrun_cancels=backend.overrun_cancels)
    return report, stats
