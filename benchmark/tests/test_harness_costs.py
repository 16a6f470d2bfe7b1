"""The yardstick's operations and bytes against shapes counted by hand."""

import pytest

from harness import costs

# Mistral-7B's widths: 8 kv heads of 128, a 4,096 window, INT8 weights.
W = dict(L=32, D=4096, n_q=32, n_kv=8, hd=128, F=14336, V=32000, window=4096,
         w_bytes=1, quant="int8", row_bytes=2 * 8 * 128 * 2)


@pytest.mark.parametrize("first,last,window", [(0, 0, 0), (0, 9, 0), (5, 20, 0),
                                               (0, 30, 8), (3, 7, 8), (10, 40, 8),
                                               (7, 7, 8), (8, 8, 8)])
def test_visible_sum_counts_each_position(first, last, window):
    want = sum(min(p + 1, window) if window else p + 1
               for p in range(first, last + 1))
    assert costs.visible_sum(first, last, window) == want


def test_decode_row_by_hand():
    # A row with 99 cached tokens feeds its 100th: 100 keys (under the
    # window), 99 read from the cache, the new row read and written.
    nbytes, flops = costs.decode_attn(W, [(1, 99, True)])
    assert nbytes == (99 + 2) * 4096 + 2 * 32 * 128 * 2
    assert flops == 4 * 32 * 128 * 100
    # Past the window it sees 4,096 keys.
    nbytes, flops = costs.decode_attn(W, [(1, 10000, True)])
    assert flops == 4 * 32 * 128 * 4096
    assert nbytes == (4096 + 1) * 4096 + 2 * 32 * 128 * 2


def test_prefill_chunk_by_hand():
    # A 512-token chunk after 8,000 cached tokens: its queries see 4,096
    # keys each; the keys any of them sees are 4,096 + 511.
    nbytes, flops = costs.prefill_attn(W, [(512, 8000, False), (1, 5, True)])
    assert flops == 4 * 32 * 128 * 4096 * 512
    assert nbytes == (4096 + 511) * 4096 + 2 * 512 * 32 * 128 * 2
    # A first chunk of 512 tokens: 1 + 2 + ... + 512 pairs.
    _, flops = costs.prefill_attn(W, [(512, 0, True)])
    assert flops == 4 * 32 * 128 * 512 * 513 // 2


def test_projection_and_head_by_hand():
    nbytes, flops = costs.proj_call(W, 64, 14336, 4096)
    assert nbytes == 14336 * 4096 + 4 * 14336 + 64 * (4096 + 14336) * 2
    assert flops == 2 * 64 * 14336 * 4096
    rows = [(1, 10, True)] * 3 + [(512, 0, False)]
    assert costs.head_call(W, rows) == costs.proj_call(W, 3, 32000, 4096)


def test_model_flops_by_hand():
    rows = [(1, 99, True), (2, 0, True)]
    params = 4096 * (4096 + 1024 + 1024 + 4096) + 3 * 4096 * 14336
    attn = 4 * 32 * 128 * (100 + 1 + 2)
    want = 32 * (2 * 3 * params + attn) + 2 * 2 * 32000 * 4096
    assert costs.model_flops(W, rows) == want


def test_bound_is_the_larger_of_bytes_and_operations():
    assert costs.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(0, 989e12) == pytest.approx(1.0)
    assert costs.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_widths_of_the_configurations():
    from harness import spec
    bench = spec.load_benchmark()
    w = costs.model_widths(spec.config(bench, "qwen2-7b"))
    assert (w["L"], w["D"], w["n_q"], w["n_kv"], w["hd"], w["F"], w["V"]) == \
        (28, 3584, 28, 4, 128, 18944, 152064)
    assert w["bias"] and w["window"] == 0 and w["w_bytes"] == 2
    # About 7.6B parameters, 57,344 bytes of KV a token.
    params = w["L"] * sum(n * k for n, k in costs.projections(w)) + 2 * w["V"] * w["D"]
    assert 7.5e9 < params < 7.7e9
    assert w["L"] * w["row_bytes"] == 57344
    m = costs.model_widths(spec.config(bench, "mistral-7b-int8"))
    assert m["window"] == 4096 and not m["bias"] and m["w_bytes"] == 1
    assert m["L"] * m["row_bytes"] == 131072
