"""The plain references against the port's reduced cuts, on the same
seeded weights: the port's prefill and decode steps (plain kernel
versions on the CPU, past its windows' wrap) against one pass of the
reference over the whole sequence."""
import numpy as np
import pytest
import torch

from perfbench.harness import spec, weights
from perfbench.reference import common, danube

CASES = [("h2o-danube-1.8b-reduced", danube)]


def _as_file(cfg):
    m = {k: getattr(cfg, k) for k in spec.MODEL_KEYS}
    m["block"] = cfg.blocks[0]
    return m


@pytest.mark.parametrize("arch,family", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_the_port(arch, family):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    m = _as_file(cfg)
    layout = family.param_layout(m)
    tree = weights.draw(layout, 2**31 + 9, torch.float32, "cpu")
    model = build_model(cfg, device="cpu")
    s, steps = 20, 6                         # past the window of 16
    tok = torch.randint(0, cfg.vocab_size, (2, s),
                        generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(2, s + steps + 1)
    with torch.no_grad():
        lg, cache = model.prefill(weights.program_params(tree),
                                  {"tokens": tok.int()}, cache=cache)
        seq, outs = [tok], [lg]
        for _ in range(steps):
            ids = outs[-1].argmax(-1)
            seq.append(ids[:, None])
            lg, cache = model.decode_step(weights.program_params(tree), cache,
                                          ids[:, None].int())
            outs.append(lg)
    full = torch.cat(seq, 1).long()
    rows = torch.arange(s - 1, s + steps)
    for b in range(2):
        ref = family.logits(tree, full[b], rows, m)
        prog = torch.stack([o[b] for o in outs])
        scale = ref.abs().max()
        assert float((ref - prog).abs().max()) <= 1e-5 * float(scale)


def test_fp8_control_rounds_the_products():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(6, 32, generator=g), torch.randn(32, 16, generator=g)
    exact = common.linear(x, w, "f32")
    low = common.linear(x, w, "fp8")
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2
    with pytest.raises(ValueError):
        common.linear(x, w, "int3")


def test_weights_from_the_seed():
    m = _as_file(__import__("repro_torch.configs", fromlist=["get_config"])
                 .get_config("h2o-danube-1.8b-reduced"))
    layout = danube.param_layout(m)
    a = weights.draw(layout, 5, torch.bfloat16, "cpu")
    b = weights.draw(layout, 5, torch.bfloat16, "cpu")
    c = weights.draw(layout, 6, torch.bfloat16, "cpu")
    assert torch.equal(a["_buffers"][0], b["_buffers"][0])
    assert not torch.equal(a["_buffers"][0], c["_buffers"][0])
    w = a["layers"][1]["mlp"]["w_gate"]
    assert w.dtype == torch.bfloat16
    std = float(w.float().std())
    assert std == pytest.approx(1 / np.sqrt(m["d_model"]), rel=0.1)
    norm = float(a["layers"][0]["norm1"].float().std())
    assert norm == pytest.approx(0.1, rel=0.2)
