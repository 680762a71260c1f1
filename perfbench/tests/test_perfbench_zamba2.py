"""The published Zamba2 cell's pieces on the CPU: its configuration file
against the program's registry, the benchmark's reference against the
port's plain reference and against the port itself (prefill and decode
steps, plain kernel versions) at a tiny size, its counts by hand, and
one traced run of the harness over the tiny model."""
import dataclasses
import json
import time

import pytest
import torch

import perfbench_tiny
import test_perfbench_faults as test_faults
from perfbench.counts import zamba2 as counts
from perfbench.harness import hybrid, measure, serve, spec, weights
from perfbench.reference import zamba2 as reference

CONF = spec.load_config(spec.load_benchmark(), "zamba2-7b")


def _tiny():
    """The tiny form of the tests of the port (tests/test_torch_zamba2_7b.py)
    as a configuration file: 6 layers, 4 hybrid, G 2, two blocks."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(
        get_config("zamba2-7b"), num_layers=6, blocks=("mamba2+none",) * 6,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=96,
        vocab_size=128, ssm_state_dim=16, ssm_head_dim=16,
        hybrid_layer_ids=(1, 2, 4, 5), adapter_rank=8, dtype="float32",
        param_dtype="float32")
    conf = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name in CONF}
    conf.update(registry_id="zamba2-7b", family="zamba2",
                block="mamba2+none",
                hybrid_layer_ids=list(cfg.hybrid_layer_ids))
    return cfg, conf


def test_the_file_is_the_registry_config():
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-7b")
    assert serve.build_config(CONF) == cfg
    fields = {f.name for f in dataclasses.fields(cfg)}
    shared = [k for k in CONF if k in fields]
    assert len(shared) >= 20
    for k in shared:
        want = getattr(cfg, k)
        assert (tuple(CONF[k]) if isinstance(want, tuple) else CONF[k]) \
            == want, k
    assert CONF["reduced"] == [] and CONF["family"] == "zamba2"
    assert CONF["hybrid_layer_ids"] == list(cfg.hybrid_layer_ids)
    # the catalog's keys, under their names
    assert (CONF["hidden_size"], CONF["mamba_ngroups"],
            CONF["attention_head_dim"], CONF["n_mamba_heads"]) == (
        cfg.d_model, cfg.ssm_groups, cfg.head_dim, cfg.ssm_num_heads)


def test_the_layout_is_the_programs_tree():
    from repro_torch.models import build_model
    cfg, conf = _tiny()
    model = build_model(cfg, device="cpu")
    tree = model.init(model.generator(0))
    drawn = weights.program_params(
        weights.draw(reference.param_layout(conf), 5, torch.float32, "cpu"))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(drawn) == shapes(tree)


def test_the_two_references_agree():
    from repro_torch.plain import zamba2 as plain
    _, conf = _tiny()
    tree = weights.draw(reference.param_layout(conf), 2**31 + 21,
                        torch.float32, "cpu")
    tok = torch.randint(0, conf["vocab_size"], (30,),
                        generator=torch.Generator().manual_seed(4))
    rows = torch.arange(30)
    ours = reference.logits(tree, tok, rows, conf)
    theirs = plain.logits(tree, tok, rows, conf)
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=1e-6)
    low = reference.logits(tree, tok, rows, conf, "fp8")
    assert not torch.allclose(low, ours, rtol=1e-3, atol=1e-3)


def test_the_reference_matches_the_port():
    """The port's prefill and decode steps on the benchmark's seeded
    weights against one pass of the reference: within 1e-4 of the logit
    scale.  Both are f32 with sums in other orders (the recurrence
    against the chunked dual form, whose decays are differences of
    cumulative sums); the benchmark's draws give the SSD more gain than
    the port's init, and 7e-5 was measured."""
    from repro_torch.models import build_model
    cfg, conf = _tiny()
    tree = weights.draw(reference.param_layout(conf), 2**31 + 9,
                        torch.float32, "cpu")
    params = weights.program_params(tree)
    model = build_model(cfg, device="cpu")
    s, steps = 16, 5
    tok = torch.randint(0, cfg.vocab_size, (2, s),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cache = model.init_cache(2, s + steps + 1)
        lg, cache = model.prefill(params, {"tokens": tok.int()}, cache=cache)
        seq, outs = [tok], [lg]
        for _ in range(steps):
            ids = outs[-1].argmax(-1)
            seq.append(ids[:, None])
            lg, cache = model.decode_step(params, cache, ids[:, None].int())
            outs.append(lg)
    full = torch.cat(seq, 1).long()
    rows = torch.arange(s - 1, s + steps)
    for b in range(2):
        ref = reference.logits(tree, full[b], rows, conf)
        prog = torch.stack([o[b] for o in outs])
        assert float((ref - prog).abs().max()) <= 1e-4 * float(
            ref.abs().max())


def test_counts_by_hand():
    m = {"d_model": 4, "ssm_expand": 2, "ssm_head_dim": 4, "ssm_ngroups": 2,
         "ssm_state_dim": 2, "ssm_conv_width": 2, "num_layers": 3,
         "num_heads": 2, "num_kv_heads": 1, "head_dim": 4, "d_ff": 6,
         "adapter_rank": 1, "hybrid_layer_ids": [1, 2], "vocab_size": 10,
         "dtype": "bfloat16"}
    # di 8, 2 heads, G N 4: x 8 * 2 + dt 2 * 4 + B, C 2 * 4 * 2 + y 8 * 4
    # (f32) a token; a_log 2 * 4; the state 4 * 8 * 2 twice
    assert counts.ssd_bound(m, 1, 1, "float32") == (
        16 + 8 + 16 + 32 + 8 + 128, 4.0 * 8 * 2, "bfloat16")
    assert counts.ssd_bound(m, 2, 3)[0] == 2 * 3 * (16 + 8 + 16 + 16) + 8 \
        + 2 * 128
    # a layer: in_proj 4 * (8 + 16 + 2) (z, x|B|C, dt), out 8 * 4, the
    # convs 2 * 16, the SSD 2 * 8 * 2; an application: q, k, v from 8
    # wide 8 * (8 + 4 + 4), o 8 * 4, mlp 3 * 4 * 6, adapter 4 + 12, L 16
    layer = 104 + 32 + 32 + 32
    app = 128 + 32 + 72 + 16 + 16
    assert counts.token_flops(m) == 2.0 * (3 * layer + 2 * app)
    assert counts.decode_useful(m, 4) == counts.token_flops(m) + 80 + \
        4.0 * 2 * 4 * 5 * 2
    assert counts.prefill_useful(m, 3) == 3 * counts.token_flops(m) + 80 + \
        4.0 * 2 * 4 * 6 * 2


def _tiny_cell(tmp_path, monkeypatch, rate=None):
    """The tiny model in the zamba2-7b-chat cell's place, its limit 2e-4
    (a tenth of danube's tiny limit: this model's logits are smaller);
    ``rate`` replaces the tiny mix's."""
    from repro_torch.configs import get_config
    cfg, conf = _tiny()
    root = perfbench_tiny.make_root(tmp_path)
    (root / "perfbench" / "configs" / "zamba2-7b.json").write_text(
        json.dumps(conf))
    (root / "perfbench" / "cells" / "zamba2-7b-chat.json").write_text(
        json.dumps({"logit_gap": 2e-4}))
    if rate:
        mix = root / "perfbench" / "traffic" / "tiny.json"
        mix.write_text(mix.read_text().replace('"rate_rps": 12.0',
                                               f'"rate_rps": {rate}'))
    monkeypatch.setattr(serve, "build_config", lambda c: dataclasses.replace(
        get_config(c["registry_id"]), **{
            k: tuple(v) if isinstance(v, list) else v for k, v in c.items()
            if k in {f.name for f in dataclasses.fields(cfg)}},
        blocks=(c["block"],) * c["num_layers"]))
    bench = spec.load_benchmark(root)
    cell = spec.find(bench["workloads"], "zamba2-7b-chat", "workload")
    return bench, cell, root


def test_a_traced_run_of_the_tiny_cell(tmp_path, monkeypatch):
    """The harness over the tiny model in the zamba2-7b-chat cell's place:
    correct, every metric of the cell read (the rooflines need a device
    trace: none here), and the readers silent on the danube cells."""
    bench, cell, root = _tiny_cell(tmp_path, monkeypatch)
    result, _ = measure.run(bench, cell, 2**31 + 31, 1.5, True,
                            time.perf_counter(), device="cpu", root=root)
    assert result["correct"] and result["failed"] == 0
    assert result["check"]["logit_gap"]["value"] < 2e-4
    got = set(result["metrics"])
    assert {"step_mfu.zchat", "decode_step_ms", "batch_fill",
            "decode_slot_waste"} <= got
    assert not got & {"ssd_scan_roofline.zchat",
                      "decode_attention_roofline.zchat",
                      "swa_prefill_roofline.zchat"}


def _slot_reads_slot_zero(path):
    """A fault: before each decode step of a gang of two or more, the
    cache leaves under ``path`` of slot 1 are slot 0's (every leaf but
    the index has the slot on axis 1)."""
    def fault(phase, fn):
        @torch.inference_mode()
        def step(cache, tok):
            node = cache
            for k in path[:-1]:
                node = node[k]
            leaves = ([node[path[-1]]] if path[-1] else list(node.values()))
            if leaves[0].shape[1] > 1:
                for v in leaves:
                    v[:, 1].copy_(v[:, 0])
            return fn(cache, tok)
        return fn if phase == "prefill" else step
    return fault


def _altered_token(phase, fn):
    """The second streamed token of every slot is another id (the tiny
    model's vocabulary is 128)."""
    @torch.inference_mode()
    def step(*args):
        ids, cache = fn(*args)
        if phase == "decode" and int(cache["index"]) == 24 + 2:
            ids.add_(1).remainder_(128)
        return ids, cache
    return step


_FAULTS = {"altered_token": _altered_token,
           "state_unchanged": test_faults.state_unchanged,
           "half_left_out": test_faults.half_left_out,
           "ssd_state_of_slot_zero": _slot_reads_slot_zero(("ssm", "h")),
           "shared_kv_of_slot_zero": _slot_reads_slot_zero(("shared", ""))}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    """Each fault in the tiny cell, at a rate whose gangs hold two or more
    requests (so the per-slot faults have a second live slot to break),
    reads a widest gap above the cell's limit."""
    test_faults._break(monkeypatch, _FAULTS[fault])
    bench, cell, root = _tiny_cell(tmp_path, monkeypatch, rate=40.0)
    result, _ = measure.run(bench, cell, 2**31 + 33, 1.0, False,
                            time.perf_counter(), device="cpu", root=root)
    assert result["generator"]["gangs"] < result["generator"]["sent"]
    assert not result["correct"]
    gap = result["check"]["logit_gap"]
    assert gap["value"] > gap["limit"]


def test_the_readers_need_a_zamba2_run():
    class Run:
        conf = {"family": "danube"}
        trace = {"kernel_s": {"ssd_chunked_kernel": 1.0}}
        gangs = []
    for k in ("ssd_scan", "decode_attention", "swa_prefill"):
        assert hybrid.roofline_pct(Run, k) is None
    assert hybrid.step_mfu_pct(Run) is None


def test_a_roofline_by_hand():
    """One traced gang of b 2 with two decode steps: ssd_scan's least time
    over its two bodies' device time."""
    from perfbench.counts import peaks
    from perfbench.harness.serve import Gang
    m = dict(CONF)

    class Run:
        conf = m
        mix = {"bucket": 512, "max_decode": 128}
        trace = {"kernel_s": {"void ssd_chunked_kernel<...>": 2e-3,
                              "void ssd_scan_kernel<...>": 3e-3,
                              "decode_attention_bf16_kernel": 1.0}}
        gangs = [Gang(0.0, 2, [0, 1], (0.0, 0.1),
                      [(0.1, 0.01), (0.11, 0.01)], True)]
    pre = peaks.bound_s(*counts.ssd_bound(m, 2, 512))
    dec = peaks.bound_s(*counts.ssd_bound(m, 2, 1, "float32"))
    want = 100.0 * 81 * (pre + 2 * dec) / 5e-3
    assert hybrid.roofline_pct(Run, "ssd_scan") == pytest.approx(want)
