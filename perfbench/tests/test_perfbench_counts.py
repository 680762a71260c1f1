"""The frozen counters against cases worked by hand."""
import pytest

from perfbench.counts import kernels, model, peaks


def test_prefill_bound_by_hand():
    # q, k, v, out of B 1, S 4, H = KV = 1, D 8 in bf16: 4 * 64 bytes;
    # window 2 keeps 1 + 2 + 2 + 2 = 7 (query, key) pairs
    assert kernels.prefill_bound(1, 4, 1, 1, 8, 2) == (256, 224.0,
                                                       "bfloat16")


@pytest.mark.parametrize("s,w", [(1, 1), (7, 3), (64, 64), (100, 4096),
                                 (4096, 4096), (5000, 4096)])
def test_prefill_pairs_closed_form(s, w):
    pairs = sum(min(p + 1, w) for p in range(s))
    assert kernels.prefill_bound(2, s, 4, 2, 16, w)[1] == \
        4.0 * 2 * 4 * 16 * pairs


def test_decode_bound_by_hand():
    # B 2, S 10, KV 1, G 2, D 8, bf16: q and out 2*2*1*2*8*2 = 128 bytes,
    # lengths 4 * 2 = 8; a row of K or V is 16 bytes: L 3 reads 2 * 3
    # rows, L 0 the mean of all 10 rows of V
    nbytes, flops, dt = kernels.decode_bound(2, 10, 1, 2, 8, [3, 0])
    assert (nbytes, flops, dt) == (136 + 96 + 160, 192.0 + 160.0,
                                   "bfloat16")


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(3.35e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 67e12, "float32") == pytest.approx(1.0)


def test_model_flops_by_hand():
    m = {"block": "swa+mlp", "num_layers": 2, "d_model": 4, "num_heads": 2,
         "num_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab_size": 10,
         "window_size": 3}
    # q, o: 4 * 4 each; k, v: 4 * 2 each; mlp: 3 * 4 * 8 = 96
    assert model.token_flops(m) == 2.0 * 2 * (32 + 16 + 96)
    assert model.head_flops(m) == 80.0
    # a 5-token prompt keeps 1 + 2 + 3 + 3 + 3 = 12 keys per layer
    assert model.prefill_useful(m, 5) == 5 * 576.0 + 80 + 4 * 2 * 2 * 12 * 2
    assert model.decode_useful(m, 9) == 576.0 + 80 + 4 * 2 * 2 * 3 * 2


def test_another_block_kind_is_refused():
    m = {"block": "mamba2+none", "num_layers": 2, "d_model": 4,
         "num_heads": 2, "num_kv_heads": 2, "head_dim": 2, "d_ff": 8,
         "vocab_size": 10}
    for count in (model.token_flops, model.attention_layers,
                  model.attention_window):
        with pytest.raises(ValueError, match="mamba2"):
            count(m)
