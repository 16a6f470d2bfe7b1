"""One step of the port's forward against the JAX package's, on the same
parameters, cache, feedback buffer and packed batch.

The batch is a SARATHI mixed step at GQA (4 q heads over 2 kv heads), three
layers: decode rows packed first (one of them reads its token from the
feedback buffer), a chunked-prefill tail that starts mid-sequence, and a
fresh prompt. The JAX side is ``forward_shard`` through the JAX
``LlamaModel`` with ``use_pallas=False``; the port runs both its paths (the
kernels' plain versions, and the gather reference).

Tolerance: f32 on both sides, only summation order differs. Logits within
atol 1e-4 / rtol 1e-4 (values of O(1) after a few hundred f32 sums);
written cache rows within atol 1e-5; greedy tokens and the feedback buffer
exactly (the top-2 margins of these random weights are far above the noise).
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import torch

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
from swiftllm_tpu.server.scheduler import ScheduledSeq as JaxScheduledSeq
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu.server.structs import Request as JaxRequest
from swiftllm_tpu.worker.model import LlamaModel as JaxLlamaModel
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy

MC = dict(num_layers=3, num_q_heads=4, num_kv_heads=2, hidden_size=64,
          head_dim=16, ffn_inter_dim=128, vocab_size=128,
          max_position_embeddings=512, rms_norm_eps=1e-5)
EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=8,
          num_hbm_blocks=32, max_blocks_per_seq=8, max_batch_size=4,
          max_tokens_in_batch=64, prefill_chunk_size=16,
          max_seqs_in_block_table=8, preemption_mode="recompute",
          use_pallas=False)
# (prompt_len, cached, outputs, n_tokens) per row; decode rows first.
ROWS = [(10, 10, [5], 1), (13, 14, [7, None], 1), (24, 8, [], 16), (5, 0, [], 5)]


def scaled_params(jax_params, rng):
    """The JAX dummy tree scaled to O(0.1) weights with unit norms, so that
    activations and logit margins are O(1) instead of uniform(±1e-3)'s
    near-ties."""
    tree = jax.tree.map(np.asarray, jax.device_get(jax_params))
    for name in ("attn_norm", "ffn_norm"):
        tree["layers"][name] = np.ones_like(tree["layers"][name])
    tree["final_norm"] = np.ones_like(tree["final_norm"])
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][k] = tree["layers"][k] * 100.0
    tree["embed"] = rng.normal(size=tree["embed"].shape).astype(np.float32)
    tree["lm_head"] = tree["lm_head"] * 100.0
    return tree


def schedule(pkg):
    Req, Raw, Sched = ((JaxRequest, JaxRawRequest, JaxScheduledSeq) if pkg == "jax"
                       else (Request, RawRequest, ScheduledSeq))
    out = []
    for i, (plen, cached, outputs, n) in enumerate(ROWS):
        r = Req(Raw("", 4))
        r.set_prompt_token_ids([(5 * i + j) % 120 + 1 for j in range(plen)])
        r.output_token_ids = list(outputs)
        r.num_cached_tokens = cached
        r.seq_id = i + 1
        out.append(Sched(r, n))
    return out


def preallocate(mgr):
    for i, (_, cached, _, _) in enumerate(ROWS):
        if cached:
            mgr.allocate_for_seq(i + 1, cached)


@pytest.fixture(scope="module")
def jax_step():
    rng = np.random.default_rng(0)
    m = JaxLlamaModel(JaxEngineConfig(**EC), JaxModelConfig(**MC))
    m.load_weights()
    m.init_kvcache_and_swap()
    tree = scaled_params(m.params, rng)
    m.params = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                            m.params, tree)
    cache = rng.normal(size=m.kv_cache.shape).astype(np.float32)
    feedback = rng.integers(0, 128, size=m.token_feedback.shape).astype(np.int32)
    m.kv_cache = jax.device_put(cache, m.kv_cache.sharding)
    m.token_feedback = jax.device_put(feedback, m.token_feedback.sharding)
    preallocate(m.hbm_block_mgrs[0])
    tokens, rows, logits = m.forward(schedule("jax"), return_logits=True)
    return dict(tree=tree, cache=cache, feedback=feedback, tokens=tokens,
                logits=logits, rows=[r is not None for r in rows],
                cache_after=np.asarray(m.kv_cache),
                feedback_after=np.asarray(m.token_feedback))


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_mixed_step_matches_jax(jax_step, use_kernels):
    ref = jax_step
    m = LlamaModel(EngineConfig(**dict(EC, use_pallas=use_kernels)),
                   LlamaModelConfig(**MC), device="cpu")
    m.params = params_from_numpy(ref["tree"], "cpu")
    m.init_kvcache_and_swap()
    m.kv_cache.copy_(torch.from_numpy(ref["cache"]))
    m.token_feedback.copy_(torch.from_numpy(ref["feedback"]))
    preallocate(m.hbm_block_mgrs[0])
    tokens, rows, logits = m.forward(schedule("torch"), return_logits=True)

    live = np.asarray(ref["rows"])
    assert [r is not None for r in rows] == ref["rows"]
    np.testing.assert_allclose(logits[live], ref["logits"][live],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tokens[live], ref["tokens"][live])
    # The feedback buffer, its last (garbage) slot excluded.
    np.testing.assert_array_equal(m.token_feedback.numpy()[:-1],
                                  ref["feedback_after"][:-1])
    # The cache, its garbage page excluded.
    ps = EC["block_size"]
    np.testing.assert_allclose(m.kv_cache.numpy()[:, :-ps],
                               ref["cache_after"][:, :-ps], atol=1e-5, rtol=0)
    assert not np.array_equal(ref["cache_after"][:, :-ps], ref["cache"][:, :-ps])


# GQA groups that do not divide the kernels' 64-row tiles (the attention
# kernels run a group under the least of 1, 2, 4, 8 at or above it): the
# head shape of Qwen2-0.5B (14 q / 2 kv heads, group 7, head_dim 64, q/k/v
# biases) and a group of 3 at head_dim 128 (Llama-3.2-3B's 24 / 8), two
# layers each, narrow elsewhere.
GQA_SHAPES = {
    "qwen2_0.5b_heads": dict(num_q_heads=14, num_kv_heads=2, head_dim=64,
                             hidden_size=128, qkv_bias=True),
    "group3_hd128": dict(num_q_heads=6, num_kv_heads=2, head_dim=128,
                         hidden_size=128),
}


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel_plain", "gather_reference"])
@pytest.mark.parametrize("shape", list(GQA_SHAPES))
def test_gqa_group_step_matches_jax(shape, use_kernels):
    """The mixed step above at GQA groups 7 and 3: the port against the JAX
    package (its jnp path, which takes any group) on the same parameters
    (biases scaled as the weights), cache, feedback buffer and batch, at the
    same tolerance: logits atol 1e-4 / rtol 1e-4, greedy tokens equal, the
    written cache rows within 1e-5."""
    mc = dict(MC, num_layers=2, ffn_inter_dim=128, **GQA_SHAPES[shape])
    rng = np.random.default_rng(7)
    jm = JaxLlamaModel(JaxEngineConfig(**EC), JaxModelConfig(**mc))
    jm.load_weights()
    jm.init_kvcache_and_swap()
    tree = scaled_params(jm.params, rng)
    assert ("bq" in tree["layers"]) == mc.get("qkv_bias", False)
    for b in ("bq", "bk", "bv"):
        if b in tree["layers"]:
            tree["layers"][b] = rng.normal(scale=0.1, size=tree["layers"][b].shape
                                           ).astype(np.float32)
    jm.params = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                             jm.params, tree)
    cache = rng.normal(size=jm.kv_cache.shape).astype(np.float32)
    feedback = rng.integers(0, 128, size=jm.token_feedback.shape).astype(np.int32)
    jm.kv_cache = jax.device_put(cache, jm.kv_cache.sharding)
    jm.token_feedback = jax.device_put(feedback, jm.token_feedback.sharding)
    preallocate(jm.hbm_block_mgrs[0])
    want_tokens, want_rows, want_logits = jm.forward(schedule("jax"),
                                                     return_logits=True)

    m = LlamaModel(EngineConfig(**dict(EC, use_pallas=use_kernels)),
                   LlamaModelConfig(**mc), device="cpu")
    m.params = params_from_numpy(tree, "cpu")
    m.init_kvcache_and_swap()
    m.kv_cache.copy_(torch.from_numpy(cache))
    m.token_feedback.copy_(torch.from_numpy(feedback))
    preallocate(m.hbm_block_mgrs[0])
    tokens, rows, logits = m.forward(schedule("torch"), return_logits=True)

    live = np.asarray([r is not None for r in want_rows])
    assert [r is not None for r in rows] == list(live)
    np.testing.assert_allclose(logits[live], want_logits[live], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tokens[live], want_tokens[live])
    ps = EC["block_size"]
    np.testing.assert_allclose(m.kv_cache.numpy()[:, :-ps],
                               np.asarray(jm.kv_cache)[:, :-ps], atol=1e-5, rtol=0)
