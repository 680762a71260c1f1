"""A run with the timed path broken underneath comes out not correct:
one fault of each kind a served cell can have.  The harness's look for a
card is skipped (the run is on the CPU, at the tiny size); everything
else is the run's own."""
import time

import pytest
import torch

import perfbench_tiny
from perfbench.harness import measure, spec


def _break(monkeypatch, fault):
    """Wrap the port's step tables, as ``make_token_live_server`` builds
    them, with ``fault``."""
    from repro_torch.serving import token_backend
    build = token_backend.build_token_step_fns

    def broken(*args, **kwargs):
        prefill_fns, decode_fns = build(*args, **kwargs)
        return ({k: fault("prefill", f) for k, f in prefill_fns.items()},
                {k: fault("decode", f) for k, f in decode_fns.items()})

    monkeypatch.setattr(token_backend, "build_token_step_fns", broken)


def altered_token(phase, fn):
    """The second streamed token of every slot is another id."""
    @torch.inference_mode()
    def step(*args):
        ids, cache = fn(*args)
        if phase == "decode" and int(cache["index"]) == 24 + 2:
            ids.add_(1).remainder_(256)
        return ids, cache
    return step


def state_unchanged(phase, fn):
    """A decode step hands back its cache as it found it."""
    @torch.inference_mode()
    def step(cache, tok):
        saved = {k: v.clone() for k, v in _flat(cache)}
        ids, out = fn(cache, tok)
        for k, v in _flat(out):
            v.copy_(saved[k])
        return ids, out
    return fn if phase == "prefill" else step


def half_left_out(phase, fn):
    """The prefill serves the first half of the gang's rows (at least one)
    and every other row the first row's prompt."""
    def step(prompts):
        prompts = torch.as_tensor(prompts).clone()
        keep = max(1, prompts.shape[0] // 2)
        prompts[keep:] = prompts[:1]
        return fn(prompts)
    return step if phase == "prefill" else fn


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _run(tmp_path, cell="danube-chat-sat", rate=None):
    root = perfbench_tiny.make_root(tmp_path)
    if rate:
        (root / "perfbench" / "traffic" / "tiny.json").write_text(
            (root / "perfbench" / "traffic" / "tiny.json").read_text()
            .replace('"rate_rps": 12.0', f'"rate_rps": {rate}'))
    bench = spec.load_benchmark(root)
    c = spec.find(bench["workloads"], cell, "workload")
    result, _ = measure.run(bench, c, 2**31 + 3, 1.0, False,
                            time.perf_counter(), device="cpu", root=root)
    return result


def test_sound_run_is_correct(tmp_path):
    assert _run(tmp_path)["correct"]


@pytest.mark.parametrize("cell", ["danube-chat-sat", "danube-docs"])
@pytest.mark.parametrize("fault", [altered_token, state_unchanged],
                         ids=["altered_token", "state_unchanged"])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, cell, fault):
    _break(monkeypatch, fault)
    result = _run(tmp_path, cell)
    assert not result["correct"]
    assert result["check"]["logit_gap"]["value"] > \
        result["check"]["logit_gap"]["limit"]


def test_half_the_gang_left_out_is_not_correct(tmp_path, monkeypatch):
    _break(monkeypatch, half_left_out)
    # a rate at which gangs hold several requests
    result = _run(tmp_path, rate=400.0)
    assert not result["correct"]


def test_the_control_is_judged_not_correct(tmp_path):
    """The calibration serves each seed as a run does and judges the fp8
    control by the run's own verdict and limits."""
    from perfbench import calibrate
    root = perfbench_tiny.make_root(tmp_path)
    bench = spec.load_benchmark(root)
    cell = spec.find(bench["workloads"], "danube-docs", "workload")
    recs = calibrate.seeds(bench, cell, [2**31 + 5, 2**31 + 6], 1.0, 1,
                           lambda rec: None, device="cpu", root=root)
    assert [r["served"]["correct"] for r in recs] == [True, True]
    assert recs[0]["control"]["correct"] is False
    gap = recs[0]["control"]["check"]["logit_gap"]
    assert gap["value"] > gap["limit"]
    assert "control" not in recs[1]
    rows = []
    calibrate.sweep(bench, cell, [6.0], 2**31 + 7, 1.0, rows.append,
                    device="cpu", root=root)
    assert rows[0]["sent"] == 6 and rows[0]["served"] == 6
