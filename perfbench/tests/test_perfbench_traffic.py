"""The traffic generator: one seed, one window; the work set by the mix."""
import numpy as np
import pytest

from perfbench.harness import spec, traffic

MIXES = ("chat", "docs")


def _mix(name, rate=6.0):
    return dict(spec.load_mix(name), rate_rps=rate)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = traffic.generate(_mix(name), 2**31 + 17, 20.0, 32000)
    b = traffic.generate(_mix(name), 2**31 + 17, 20.0, 32000)
    assert [(r.send, r.comm_latency, r.decode_tokens) for r in a] == \
        [(r.send, r.comm_latency, r.decode_tokens) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_reorder_one_set_of_work(name):
    """Another seed sends the same lengths and gaps in another order,
    with other prompt ids."""
    a = traffic.generate(_mix(name), 1, 30.0, 32000)
    b = traffic.generate(_mix(name), 2, 30.0, 32000)
    assert len(a) == len(b) == 180
    assert sorted(r.prompt_tokens for r in a) == \
        sorted(r.prompt_tokens for r in b)
    assert sorted(r.decode_tokens for r in a) == \
        sorted(r.decode_tokens for r in b)
    ga = np.diff([0.0] + [r.send for r in a])
    gb = np.diff([0.0] + [r.send for r in b])
    assert np.allclose(np.sort(ga), np.sort(gb))
    assert [r.prompt_tokens for r in a] != [r.prompt_tokens for r in b]
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])


@pytest.mark.parametrize("name", MIXES)
def test_lengths_slos_and_sends(name):
    mix = _mix(name, 9.0)
    reqs = traffic.generate(mix, 5, 40.0, 32000)
    assert len(reqs) == 360
    sends = [r.send for r in reqs]
    assert sends == sorted(sends) and 0.0 <= sends[0] and sends[-1] < 40.0
    p, d = mix["prompt"], mix["decode"]
    assert all(p["lo"] <= r.prompt_tokens <= p["hi"] <= mix["bucket"]
               for r in reqs)
    assert all(d["lo"] <= r.decode_tokens <= d["hi"] <= mix["max_decode"]
               for r in reqs)
    assert {r.ttft_slo for r in reqs} == {mix["ttft_slo_s"]}
    assert {r.tbt_slo for r in reqs} == {mix["tbt_slo_s"]}
    assert all(0.02 <= r.comm_latency < 1.0 for r in reqs)
    assert all(r.prompt.dtype == np.int32 and r.prompt.max() < 32000
               for r in reqs)
    med = np.median([r.prompt_tokens for r in reqs])
    assert 0.8 * p["median"] <= med <= 1.25 * p["median"]


def test_chat_and_docs_parameters():
    chat, docs = spec.load_mix("chat"), spec.load_mix("docs")
    assert (chat["bucket"], chat["max_decode"], chat["ttft_slo_s"],
            chat["tbt_slo_s"]) == (512, 128, 1.0, 0.08)
    assert (docs["bucket"], docs["max_decode"], docs["ttft_slo_s"],
            docs["tbt_slo_s"]) == (4096, 32, 2.5, 0.15)
    assert chat["b_set"] == [1, 2, 4, 8, 16] and docs["b_set"] == [1, 2, 4, 8]


def test_a_cell_mix_extends_its_base(tmp_path):
    (tmp_path / "base.json").write_text(
        '{"prompt": {"median": 4, "sigma": 0.1, "lo": 1, "hi": 8}}')
    (tmp_path / "cell.json").write_text('{"extends": "base", "rate_rps": 3}')
    mix = traffic.load_mix("cell", tmp_path)
    assert mix["rate_rps"] == 3 and mix["prompt"]["hi"] == 8
    with pytest.raises(ValueError, match="lacks"):
        traffic.check_mix(mix)


def test_every_cell_mix_is_complete():
    bench = spec.load_benchmark()
    for cell in bench["workloads"]:
        mix = spec.load_mix(cell["traffic"])
        traffic.check_mix(mix)
        assert mix["rate_rps"] > 0


@pytest.mark.parametrize("name", MIXES)
def test_rotation_keeps_which_requests_meet(name):
    """A seed wraps one sequence of (gap, prompt, answer) around a drawn
    start: every gap keeps the request it led to."""
    mix = _mix(name, 5.0)
    trips = []
    for seed in (3, 4):
        reqs = traffic.generate(mix, seed, 20.0, 32000)
        gaps = np.diff([0.0] + [r.send for r in reqs])
        trips.append([(round(g, 9), r.prompt_tokens, r.decode_tokens)
                      for g, r in zip(gaps, reqs)])
    a, b = trips
    # the first gap of a rotation is the wrapped one; every other
    # (gap, lengths) triple of b follows its neighbour as in a
    k = next(i for i in range(len(a)) if a[i][1:] == b[0][1:]
             and a[(i + 1) % len(a)] == b[1])
    assert all(b[j] == a[(k + j) % len(a)] for j in range(1, len(b)))
