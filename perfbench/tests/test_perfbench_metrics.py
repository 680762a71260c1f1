"""The metric arithmetic on synthetic spans."""
import math

import numpy as np
import pytest

from perfbench.harness import layers, spec, stats, trace
from perfbench.harness.serve import Gang, Run
from perfbench.harness.traffic import Req

MIX = {"bucket": 8, "max_decode": 4}
CONF = {"block": "swa+mlp", "num_layers": 1, "d_model": 4, "num_heads": 2,
        "num_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab_size": 10,
        "window_size": 16, "dtype": "bfloat16"}


def _req(i, send, prompt, decode, cl=0.1, slo=1.0, tbt=0.05):
    return Req(i, send, cl, np.zeros(prompt, np.int32), decode, slo, tbt)


def _run(reqs, gangs, seconds=10.0, trace_digest=None):
    tokens, dispatch = {}, {}
    for g in gangs:
        for i in g.reqs:
            tokens[i] = [g.prefill[0] + g.prefill[1]] + [
                t0 + dt for t0, dt in g.decode[:reqs[i].decode_tokens]]
            dispatch[i] = g.dispatch
    return Run("c", CONF, MIX, seconds, reqs, gangs, tokens, dispatch, 1.0,
               [], trace_digest)


def _setting():
    """Three requests: 0 and 1 share a gang of b 2 (two decode steps), 2
    is never served."""
    reqs = [_req(0, 0.0, 3, 2), _req(1, 0.5, 5, 1), _req(2, 9.0, 2, 1)]
    g = Gang(dispatch=1.0, b=2, reqs=[0, 1], prefill=(1.0, 0.2),
             decode=[(1.2, 0.04), (1.24, 0.06)], traced=True)
    return reqs, [g]


@pytest.mark.parametrize("q", [0, 25, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(3).exponential(size=37))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_reaching_a_failure_is_infinite():
    assert stats.percentile([1.0, 2.0, math.inf], 90) == math.inf
    assert stats.percentile([1.0] * 9 + [math.inf], 50) == 1.0
    assert stats.percentile([], 50) is None


def test_ttft_attainment_and_failures():
    reqs, gangs = _setting()
    run = _run(reqs, gangs)
    assert stats.ttfts(run) == [pytest.approx(1.2), pytest.approx(0.7),
                                math.inf]
    # request 0's second gap is 60 ms > its 50 ms TBT limit; 1 meets both;
    # 2 was never served and misses
    assert not stats.met(run, reqs[0]) and stats.met(run, reqs[1])
    assert stats.attainment_pct(run) == pytest.approx(100.0 / 3)


def test_tokens_and_gaps_inside_the_window():
    reqs, gangs = _setting()
    assert stats.tokens_in_window(_run(reqs, gangs)) == 5
    short = _run(reqs, gangs, seconds=1.25)
    # tokens at 1.2, 1.24 (request 0) and 1.2, 1.24 (request 1) fall
    # inside 1.25 s; request 0's 1.30 does not
    assert stats.tokens_in_window(short) == 4
    assert stats.gaps_in_window(short) == [pytest.approx(0.04),
                                           pytest.approx(0.04)]


def test_slot_waste_padding_fill_and_waits():
    reqs, gangs = _setting()
    run = _run(reqs, gangs)
    # 2 + 1 live slot-steps of 2 slots x 2 steps
    assert layers.decode_slot_waste_pct(run) == pytest.approx(25.0)
    # 3 + 5 real prompt tokens of 2 x 8
    assert layers.prefill_pad_pct(run) == pytest.approx(50.0)
    assert layers.batch_fill_pct(run) == pytest.approx(100.0)
    assert layers.decode_step_ms(run) == pytest.approx(50.0)
    assert layers.prefill_ms_per_ktok(run) == pytest.approx(0.2e3 / 0.016)
    # waits 0.9 and 0.4; the unserved request waits forever
    assert layers.queue_wait_p90_s(run) == math.inf


def test_step_mfu_counts_useful_work_only():
    from perfbench.counts import model, peaks
    reqs, gangs = _setting()
    run = _run(reqs, gangs)
    flops = (model.prefill_useful(CONF, 3) + model.prefill_useful(CONF, 5)
             + model.decode_useful(CONF, 8) + model.decode_useful(CONF, 9)
             + model.decode_useful(CONF, 8))
    assert layers.step_mfu_pct(run) == pytest.approx(
        100.0 * flops / (0.3 * peaks.PEAK_FLOPS_BF16))


def test_roofline_over_the_traced_calls():
    from perfbench.counts import kernels, peaks
    reqs, gangs = _setting()
    digest = {"kernel_s": {"void x::decode_attention_bf16_kernel<80, 4>": 2e-6,
                           "swa_prefill_bf16_kernel<80>": 1e-6},
              "busy_s": 1.0, "step_busy_s": 0.25, "step_wall_s": 0.3}
    run = _run(reqs, gangs, trace_digest=digest)
    s = min(8 + 4 + 1, 16)
    bound = sum(peaks.bound_s(*kernels.decode_bound(2, s, 1, 2, 2, [n] * 2))
                for n in (9, 10))
    assert layers.roofline_pct(run, "decode_attention") == pytest.approx(
        100.0 * bound / 2e-6)
    quiet = dict(digest, kernel_s={k: v for k, v in digest["kernel_s"].items()
                                   if "swa" not in k})
    assert layers.roofline_pct(_run(reqs, gangs, trace_digest=quiet),
                               "swa_prefill") is None
    assert layers.step_idle_pct(run) == pytest.approx(100.0 / 6)
    assert layers.roofline_pct(_run(reqs, gangs), "swa_prefill") is None


def test_trace_reduction():
    ms = 1_000_000
    device = [(0, 2 * ms, "k1"), (1 * ms, 3 * ms, "k2"), (5 * ms, 6 * ms, "k1")]
    spans = [(0, 10 * ms, "harness.step_until"),
             (0, 7 * ms, "program.execute"),
             (0, 3 * ms + ms // 2, "program.prefill"),
             (3 * ms + ms // 2, 7 * ms, "program.decode"),
             (10 * ms, 12 * ms, "harness.sleep")]
    out = trace.reduce_trace(device, spans, 0.012)
    assert out["busy_s"] == pytest.approx(0.004)
    assert out["kernel_s"] == {"k1": pytest.approx(0.003),
                               "k2": pytest.approx(0.002)}
    assert out["step_busy_s"] == pytest.approx(0.004)
    assert out["step_wall_s"] == pytest.approx(0.007)
    gaps = dict(out["idle_gaps"])
    # 3-5 ms idle inside the steps' spans (the 4 ms midpoint in decode),
    # 6-12 ms: midpoint 9 ms inside step_until only
    assert gaps == {"program.decode": pytest.approx(0.002),
                    "harness.step_until": pytest.approx(0.006)}
    assert out["device_ops"][0] == ["k1", pytest.approx(0.003)]


def test_each_metric_has_a_reader_that_reads_a_run():
    bench = spec.load_benchmark()
    reqs, gangs = _setting()
    run = _run(reqs, gangs)
    for m in bench["end_to_end"] + bench["per_layer"]:
        read = spec.metric_reader(m["name"])
        value = read(run)
        assert value is None or isinstance(value, float), m["name"]
