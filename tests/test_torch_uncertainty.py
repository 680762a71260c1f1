"""The port's decode-length uncertainty against the JAX package.

``core/uncertainty.py`` is a copy of the reference's: the same
distribution, the same observations and the same workload give the same
quantiles, samples, slack and stats, and ``TokenSimBackend``'s
speculative admission cancels the same streams (``overrun_cancels``),
with no float tolerance.  Mirrors ``tests/test_uncertainty.py`` on the
exact engine, the hypothesis-pinned quantile conservativeness included.
"""
import dataclasses
import math

import numpy as np
import pytest
from _hyp import given, settings, st  # guarded hypothesis import

from repro.core import uncertainty as ju
from repro.serving import scenarios as jax_scenarios
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.core.uncertainty import (EmpiricalLengths,
                                          LengthDistribution,
                                          LengthPredictor, LognormalLengths,
                                          MixtureLengths, PointMass,
                                          UncertaintyConfig)
from repro_torch.serving.scenarios import (_run_token_scenario,
                                           build_scenario, run_scenario)

C_SET = (1, 2, 4, 8, 16, 24, 32)
B_SET = (1, 2, 4, 8, 16, 32, 64)


def pair(kind):
    """The same distribution in both packages."""
    specs = {
        "point": lambda m: m.PointMass(24),
        "empirical": lambda m: m.EmpiricalLengths((5, 1, 9, 3, 7, 7, 40)),
        "lognormal": lambda m: m.LognormalLengths(median=16, sigma=1.4,
                                                  lo=1, hi=1024),
        "lognormal-clipped": lambda m: m.LognormalLengths(
            median=64, sigma=0.9, lo=8, hi=768),
        "lognormal-wide": lambda m: m.LognormalLengths(median=40,
                                                       sigma=0.5),
        "mixture": lambda m: m.MixtureLengths(
            (m.LognormalLengths(median=16, sigma=0.6, lo=1, hi=128),
             m.LognormalLengths(median=64, sigma=0.9, lo=8, hi=768)),
            (0.65, 0.35)),
    }
    import repro_torch.core.uncertainty as pu
    return specs[kind](pu), specs[kind](ju)


# --------------------------------------------------------------------------
# distributions: equal to the reference, and their own contracts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["point", "empirical", "lognormal",
                                  "lognormal-clipped", "lognormal-wide",
                                  "mixture"])
def test_distribution_equals_reference(kind):
    mine, ref = pair(kind)
    assert isinstance(mine, LengthDistribution)
    assert mine.is_point() == ref.is_point()
    assert mine.mean() == ref.mean()
    for x in (0, 1, 3.5, 7, 16, 64, 100, 767, 768, 1024, 5000):
        assert mine.cdf(x) == ref.cdf(x), x
    for q in (1e-9, 0.05, 0.1, 0.5, 0.9, 0.95, 0.99, 1 - 1e-12):
        assert mine.quantile(q) == ref.quantile(q), q
    np.testing.assert_equal(mine.sample(np.random.default_rng(5), 500),
                            ref.sample(np.random.default_rng(5), 500))


def test_point_mass_basics():
    d = PointMass(24)
    assert d.is_point() and d.mean() == 24
    for q in (0.01, 0.5, 0.99):
        assert d.quantile(q) == 24
    assert d.cdf(23) == 0.0 and d.cdf(24) == 1.0
    assert set(d.sample(np.random.default_rng(0), 8).tolist()) == {24}


def test_empirical_quantile_is_order_statistic():
    d = EmpiricalLengths((5, 1, 9, 3, 7))
    assert not d.is_point()
    assert [d.quantile(q) for q in (0.2, 0.5, 0.9, 0.99)] == [1, 5, 9, 9]
    assert d.mean() == pytest.approx(5.0)
    assert EmpiricalLengths((4, 4, 4)).is_point()
    assert EmpiricalLengths.from_array(np.array([3, 1])).samples == (1.0, 3.0)
    with pytest.raises(ValueError):
        EmpiricalLengths(())


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9, 0.99])
def test_lognormal_quantile_inverts_cdf(q):
    d = LognormalLengths(median=16, sigma=1.4, lo=1, hi=1024)
    v = d.quantile(q)
    assert d.cdf(v) >= q
    assert v == 1 or d.cdf(v - 1) < q
    assert abs(d.quantile(0.5) - 16) <= 1


def test_lognormal_point_cases_and_validation():
    assert LognormalLengths(median=16, sigma=0.0).is_point()
    assert LognormalLengths(median=16, sigma=1.0, lo=8, hi=8).is_point()
    with pytest.raises(ValueError):
        LognormalLengths(median=0, sigma=1.0)
    with pytest.raises(ValueError):
        LognormalLengths(median=4, sigma=1.0, lo=9, hi=3)


def test_lognormal_matches_generator():
    """The declared distribution is the generator's: sampled mass per
    quantile tracks the analytic CDF."""
    d = LognormalLengths(median=16, sigma=1.4, lo=1, hi=1024)
    xs = d.sample(np.random.default_rng(3), 20_000)
    assert xs.min() >= 1 and xs.max() <= 1024
    for q in (0.25, 0.5, 0.75, 0.9):
        v = d.quantile(q)
        assert abs(float((xs <= v).mean()) - d.cdf(v)) < 0.02


def test_mixture_cdf_is_weighted_sum():
    a = LognormalLengths(median=16, sigma=0.6, lo=1, hi=128)
    b = LognormalLengths(median=64, sigma=0.9, lo=8, hi=768)
    m = MixtureLengths((a, b), (0.65, 0.35))
    assert not m.is_point()
    for x in (4, 16, 64, 256):
        assert m.cdf(x) == pytest.approx(0.65 * a.cdf(x) + 0.35 * b.cdf(x))
    assert m.mean() == pytest.approx(0.65 * a.mean() + 0.35 * b.mean())
    for q in (0.1, 0.5, 0.9):
        v = m.quantile(q)
        assert m.cdf(v) >= q and (v == 1 or m.cdf(v - 1) < q)
    assert MixtureLengths((PointMass(7), PointMass(7)), (0.5, 0.5)).is_point()
    assert not MixtureLengths((PointMass(7), PointMass(9)),
                              (0.5, 0.5)).is_point()
    with pytest.raises(ValueError):
        MixtureLengths((a,), (0.5, 0.5))


@pytest.mark.parametrize("q", [0.0, 1.0, -0.2, 1.5])
def test_invalid_quantile_rejected(q):
    with pytest.raises(ValueError):
        LognormalLengths(median=16, sigma=1.0).quantile(q)


# --------------------------------------------------------------------------
# quantile conservativeness (hypothesis)
# --------------------------------------------------------------------------
def _coverage_tol(n: int, q: float) -> float:
    return 4.0 * math.sqrt(q * (1.0 - q) / n) + 0.01


@settings(deadline=None, max_examples=40)
@given(median=st.floats(2.0, 80.0), sigma=st.floats(0.05, 2.0),
       q=st.floats(0.05, 0.99), seed=st.integers(0, 2**31 - 1))
def test_lognormal_coverage_never_exceeds_tail(median, sigma, q, seed):
    """P(X > quantile(q)) <= 1 - q, checked on sampled mass; the port's
    quantile is the reference's."""
    d = LognormalLengths(median=median, sigma=sigma, lo=1, hi=2048)
    ref = ju.LognormalLengths(median=median, sigma=sigma, lo=1, hi=2048)
    assert d.quantile(q) == ref.quantile(q)
    n = 4000
    xs = d.sample(np.random.default_rng(seed), n)
    over = float((xs > d.quantile(q)).mean())
    assert over <= (1.0 - q) + _coverage_tol(n, q), (over, 1 - q)


@settings(deadline=None, max_examples=40)
@given(seed=st.integers(0, 2**31 - 1), q=st.floats(0.05, 0.99),
       n_samples=st.integers(10, 400))
def test_empirical_coverage_never_exceeds_tail(seed, q, n_samples):
    base = np.random.default_rng(seed).integers(1, 500, n_samples)
    d = EmpiricalLengths.from_array(base)
    assert d.quantile(q) == ju.EmpiricalLengths.from_array(base).quantile(q)
    over = float((base > d.quantile(q)).mean())
    assert over <= (1.0 - q) + 1e-12, (over, 1 - q)


# --------------------------------------------------------------------------
# the predictor: calibration error -> slack, monotone
# --------------------------------------------------------------------------
def _predictor_at_overrun_frac(frac, tail=0.1, n=256, cls=LengthPredictor):
    p = cls(window=n)
    n_over = int(round(frac * n))
    for i in range(n):
        p.observe(1.0, 2.0 if i < n_over else 0.0, tail=tail)
    return p


def test_slack_monotone_in_calibration_error():
    fracs = [0.0, 0.1, 0.15, 0.3, 0.5, 0.8, 1.0]
    preds = [_predictor_at_overrun_frac(f) for f in fracs]
    errs = [p.calibration_error() for p in preds]
    slacks = [p.slack_factor() for p in preds]
    assert errs == sorted(errs) and slacks == sorted(slacks)
    assert slacks[0] == 1.0 and slacks[-1] > slacks[0]
    refs = [_predictor_at_overrun_frac(f, cls=ju.LengthPredictor)
            for f in fracs]
    assert errs == [p.calibration_error() for p in refs]
    assert slacks == [p.slack_factor() for p in refs]


def test_correct_coverage_converges_to_floor():
    p = _predictor_at_overrun_frac(0.1, tail=0.1)
    assert p.calibration_error() <= 1.0 / p.window + 1e-12
    assert p.slack_factor() == pytest.approx(1.0, abs=0.05)
    p = _predictor_at_overrun_frac(0.25, tail=0.25)
    assert p.calibration_error() <= 1.0 / p.window + 1e-12


def test_prior_narrows_with_observations():
    p = LengthPredictor(window=100, prior_error=0.05)
    assert p.calibration_error() == pytest.approx(0.05)
    errs = [p.calibration_error()]
    for _ in range(100):
        p.observe(1.0, 0.0, tail=0.1)
        errs.append(p.calibration_error())
    assert errs == sorted(errs, reverse=True)
    assert errs[-1] == pytest.approx(0.0) and p.n_observed == 100
    assert _predictor_at_overrun_frac(0.0, tail=0.5).slack_factor() == 1.0


def test_predictor_validation():
    with pytest.raises(ValueError):
        LengthPredictor(window=0)
    with pytest.raises(ValueError):
        LengthPredictor(floor=2.0, cap=1.0)


@settings(deadline=None, max_examples=30)
@given(seed=st.integers(0, 2**31 - 1))
def test_slack_monotone_under_random_histories(seed):
    """Extra overruns never lower the slack; the port's predictor walks
    the reference's numbers on the same history."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 200))
    overruns = rng.uniform(0, 1, n) < rng.uniform(0.05, 0.6)
    a, b = LengthPredictor(window=64), LengthPredictor(window=64)
    ref = ju.LengthPredictor(window=64)
    for o in overruns:
        a.observe(1.0, 2.0 if o else 0.0, tail=0.1)
        ref.observe(1.0, 2.0 if o else 0.0, tail=0.1)
        b.observe(1.0, 2.0, tail=0.1)
    assert b.calibration_error() >= a.calibration_error() - 1e-12
    assert b.slack_factor() >= a.slack_factor() - 1e-12
    assert (a.calibration_error(), a.slack_factor()) == \
        (ref.calibration_error(), ref.slack_factor())


# --------------------------------------------------------------------------
# config plumbing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(admission_quantile=1.0),
                                dict(overrun_margin=0.5),
                                dict(class_quantiles=((0.0, 0.9),)),
                                dict(class_quantiles=((1.0, 1.5),))])
def test_config_validation(kw):
    with pytest.raises(ValueError):
        UncertaintyConfig(dist=LognormalLengths(median=16, sigma=1.0), **kw)


def test_class_quantiles_route_by_slo():
    d = LognormalLengths(median=16, sigma=1.0)
    cfg = UncertaintyConfig(dist=d, admission_quantile=0.9,
                            class_quantiles=((1.0, 0.99), (2.5, 0.8)))
    assert [cfg.quantile_for(s) for s in (0.5, 1.0, 2.0, 10.0)] == \
        [0.99, 0.99, 0.8, 0.9]
    assert cfg.planned_length(0.5) == d.quantile(0.99)


def test_budget_widens_with_slack_and_stats_equal_reference():
    mine, ref = pair("lognormal")
    cfg = UncertaintyConfig(dist=mine, admission_quantile=0.9)
    jcfg = ju.UncertaintyConfig(dist=ref, admission_quantile=0.9)
    b0 = cfg.budget_tokens(1.0)
    assert b0 >= mine.quantile(0.9) and b0 == jcfg.budget_tokens(1.0)
    assert cfg.stats() == jcfg.stats()
    for c in (cfg, jcfg):
        for _ in range(c.predictor.window):        # every stream overruns
            c.predictor.observe(1.0, 2.0, tail=0.1)
    assert cfg.budget_tokens(1.0) > b0
    assert cfg.drag_estimate() > mine.quantile(0.9)
    assert cfg.drag_estimate() == jcfg.drag_estimate()
    assert cfg.stats() == jcfg.stats()
    assert UncertaintyConfig().is_point() and \
        UncertaintyConfig(dist=PointMass(3)).is_point()


# --------------------------------------------------------------------------
# the exact engine: point-mass reduction and cancel-on-overrun
# --------------------------------------------------------------------------
def _full_sig(rep):
    return repr((rep.n_requests, rep.n_violations, rep.n_cancelled,
                 rep.core_seconds, rep.tokens_served, rep.ttft_p50,
                 rep.ttft_p99, rep.tbt_violation_rate,
                 [(t, d.c, d.b, d.n, d.feasible, d.predicted_tbt)
                  for t, d in rep.decisions], rep.buckets))


@pytest.mark.parametrize("scenario", ["llm-chat", "llm-mixed-len"])
def test_point_mass_reduces_bit_identically(scenario):
    """Declaring a PointMass reproduces the deterministic run verbatim."""
    batch, meta = build_scenario(scenario, requests=400, seed=5)
    kw = dict(policy="sponge", engine="exact", c_set=C_SET, b_set=B_SET,
              c0=16, tick=meta["tick"], horizon=None)
    base, _ = _run_token_scenario(batch, dict(meta), **kw)
    m2 = dict(meta, decode_dist=PointMass(24))
    pm, stats = _run_token_scenario(
        dataclasses.replace(batch, decode_dist=PointMass(24)), m2, **kw)
    assert stats["uncertainty"]["point"] is True
    assert stats["uncertainty"]["overrun_cancels"] == 0
    assert _full_sig(base) == _full_sig(pm)
    sz, _ = _run_token_scenario(batch, dict(
        meta, decode_dist=LognormalLengths(median=24, sigma=0.0)), **kw)
    assert _full_sig(base) == _full_sig(sz)


def test_disabled_quantile_is_identical_to_no_dist():
    """admission_quantile=0.0 turns the mechanism off although the
    scenario declares a distribution: the run is the one without it."""
    rep0, s0 = run_scenario("llm-heavy-tail", engine="exact", requests=400,
                            seed=4, admission_quantile=0.0)
    assert "uncertainty" not in s0 and rep0.n_cancelled == 0
    batch, meta = build_scenario("llm-heavy-tail", requests=400, seed=4)
    meta.pop("decode_dist")
    plain, stats = _run_token_scenario(batch, meta, policy="sponge",
                                       engine="exact", c_set=DEFAULT_C,
                                       b_set=DEFAULT_B,
                                       c0=16, tick=meta["tick"],
                                       horizon=None)
    assert "uncertainty" not in stats
    assert _full_sig(plain) == _full_sig(rep0)


@pytest.mark.parametrize("kw", [dict(), dict(speculative=False),
                                dict(admission_quantile=0.75),
                                dict(admission_quantile=0.97)])
@pytest.mark.parametrize("name", ["llm-heavy-tail",
                                  "retrieve-then-generate"])
def test_uncertainty_runs_equal_reference(name, kw):
    """Stats, ``overrun_cancels`` and the whole report equal the
    reference's exact engine under every admission knob."""
    rep, stats = run_scenario(name, engine="exact", requests=500, seed=7,
                              **kw)
    jrep, jstats = jax_scenarios.run_scenario(name, engine="exact",
                                              requests=500, seed=7, **kw)
    assert stats["uncertainty"] == jstats["uncertainty"]
    assert _full_sig(rep) == _full_sig(jrep)
    assert stats["uncertainty"]["n_observed"] > 0
    assert 1.0 <= stats["uncertainty"]["slack_factor"] <= 3.0


def test_overrun_cancels_free_slots_not_inflate_cost():
    common = dict(engine="exact", requests=800, seed=13)
    spec, s_on = run_scenario("llm-heavy-tail", **common)
    nospec, s_off = run_scenario("llm-heavy-tail", speculative=False,
                                 **common)
    assert spec.n_cancelled > 0
    assert s_on["uncertainty"]["overrun_cancels"] == spec.n_cancelled
    assert nospec.n_cancelled == 0
    assert s_off["uncertainty"]["overrun_cancels"] == 0
    assert spec.n_requests + spec.n_cancelled == nospec.n_requests
    assert spec.core_seconds <= nospec.core_seconds + 1e-9
    assert np.isfinite(spec.ttft_p99) and np.isfinite(spec.p99)
    assert spec.n_violations <= spec.n_requests


def test_overrun_cancels_bounded_by_promised_tail():
    """Speculative admission cancels at most the promised tail mass."""
    for seed in (0, 1, 2):
        rep, stats = run_scenario("llm-heavy-tail", engine="exact",
                                  requests=500, seed=seed)
        q = stats["uncertainty"]["quantile"]
        total = rep.n_requests + rep.n_cancelled
        assert rep.n_cancelled / total <= (1.0 - q) + _coverage_tol(total, q)


# --------------------------------------------------------------------------
# the fast engine (TokenFastSimRunner, TokenFastSession's speculative
# admission with cancel-on-overrun)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", ["llm-chat", "llm-mixed-len"])
def test_point_mass_reduces_bit_identically_fast(scenario):
    batch, meta = build_scenario(scenario, requests=400, seed=5)
    kw = dict(policy="sponge", engine="fast", c_set=C_SET, b_set=B_SET,
              c0=16, tick=meta["tick"], horizon=None,
              budget_quantum=0.01, lam_quantum=0.5)
    base, _ = _run_token_scenario(batch, dict(meta), **kw)
    pm, stats = _run_token_scenario(
        dataclasses.replace(batch, decode_dist=PointMass(24)),
        dict(meta, decode_dist=PointMass(24)), **kw)
    assert stats["uncertainty"]["point"] is True
    assert stats["uncertainty"]["overrun_cancels"] == 0
    assert _full_sig(base) == _full_sig(pm)
    sz, _ = _run_token_scenario(batch, dict(
        meta, decode_dist=LognormalLengths(median=24, sigma=0.0)), **kw)
    assert _full_sig(base) == _full_sig(sz)
    jbatch, jmeta = jax_scenarios.build_scenario(scenario, requests=400,
                                                 seed=5)
    jbase, _ = jax_scenarios._run_token_scenario(jbatch, dict(jmeta), **kw)
    assert _full_sig(base) == _full_sig(jbase)


@pytest.mark.parametrize("kw", [dict(), dict(speculative=False),
                                dict(admission_quantile=0.75),
                                dict(admission_quantile=0.0)])
@pytest.mark.parametrize("name", ["llm-heavy-tail",
                                  "retrieve-then-generate"])
def test_uncertainty_runs_equal_reference_fast(name, kw):
    """The fast engine's speculative admission under every admission
    knob: stats (``overrun_cancels`` included), solver stats and the
    whole report equal the reference's fast engine."""
    rep, stats = run_scenario(name, requests=600, seed=7, **kw)
    jrep, jstats = jax_scenarios.run_scenario(name, engine="fast",
                                              requests=600, seed=7, **kw)
    assert stats["engine"] == "fast"
    assert stats.get("uncertainty") == jstats.get("uncertainty")
    assert stats["solver"] == jstats["solver"]
    assert _full_sig(rep) == _full_sig(jrep)
    if kw.get("admission_quantile") == 0.0:
        assert "uncertainty" not in stats and rep.n_cancelled == 0
    else:
        assert stats["uncertainty"]["n_observed"] > 0


def test_overrun_cancels_free_slots_not_inflate_cost_fast():
    common = dict(engine="fast", requests=1000, seed=13)
    spec, s_on = run_scenario("llm-heavy-tail", **common)
    nospec, s_off = run_scenario("llm-heavy-tail", speculative=False,
                                 **common)
    assert spec.n_cancelled > 0
    assert s_on["uncertainty"]["overrun_cancels"] == spec.n_cancelled
    assert nospec.n_cancelled == 0
    assert s_off["uncertainty"]["overrun_cancels"] == 0
    assert spec.n_requests + spec.n_cancelled == nospec.n_requests
    assert spec.core_seconds <= nospec.core_seconds + 1e-9
    assert np.isfinite(spec.ttft_p99) and np.isfinite(spec.p99)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overrun_cancels_bounded_by_promised_tail_fast(seed):
    rep, stats = run_scenario("llm-heavy-tail", engine="fast",
                              requests=600, seed=seed)
    q = stats["uncertainty"]["quantile"]
    total = rep.n_requests + rep.n_cancelled
    assert rep.n_cancelled / total <= (1.0 - q) + _coverage_tol(total, q)


def test_aware_never_more_violations_than_promised_fast():
    rep, stats = run_scenario("llm-heavy-tail", engine="fast",
                              requests=1500, seed=11)
    q = stats["uncertainty"]["quantile"]
    assert rep.violation_rate <= (1.0 - q) + _coverage_tol(
        max(rep.n_requests, 1), q)


def test_retrieve_then_generate_class_quantiles_and_feedback_fast():
    """The RAG scenario carries per-class quantiles end to end on the
    fast engine, and the shared config closes the calibration loop."""
    rep, stats = run_scenario("retrieve-then-generate", engine="fast",
                              requests=1000, seed=8)
    unc = stats["uncertainty"]
    assert unc["speculative"] is True and rep.n_cancelled > 0
    assert rep.n_requests > 0 and np.isfinite(rep.ttft_p99)
    assert unc["n_observed"] > 0 and 1.0 <= unc["slack_factor"] <= 3.0
    assert unc["calibration_error"] >= 0.0
