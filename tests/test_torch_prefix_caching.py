"""Automatic prefix caching in the port, on the CPU.

The ports of tests/test_prefix_caching.py: the block manager's radix
match/register round trip, never matching a whole prompt, refcounts and leak
freedom, eviction that invalidates descendants; the port's Engine sharing
pages with outputs equal to an uncached run; recompute preemption riding the
cache; and on a tiny HF Llama checkpoint built locally, a generation from
matched pages equal to HF's greedy tokens.

Parity: the JAX Engine and the port's Engine on the same tiny weights (the
JAX dummy tree scaled to O(0.1), see tests/test_torch_llama.py) with prefix
caching on give equal tokens, and each request matches the same number of
prompt tokens in both.
"""

import asyncio

import numpy as np

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
from swiftllm_tpu.server.engine import Engine as JaxEngine
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu.worker.model import LlamaModel as JaxLlamaModel
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.block_manager import BlockManager
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_llama import scaled_params

PS = 4  # block size for the unit tests


def mk(num_blocks=16):
    return BlockManager("hbm0", num_blocks, PS, max_seqs=8,
                        max_blocks_per_seq=8, enable_prefix_caching=True)


def toks(n, base=0):
    return [base + i for i in range(n)]


def test_match_register_roundtrip():
    m = mk()
    prompt = toks(11)   # 2 full pages + tail
    m.allocate_for_seq(0, 11)
    m.register_prefix(0, prompt, 11)
    assert m.match_prefix(1, prompt) == 2 * PS
    assert m.seq_block_ids(1).tolist() == m.seq_block_ids(0)[:2].tolist()
    other = prompt[:PS] + [99] * 7      # diverges in the second page
    assert m.match_prefix(2, other) == PS
    assert m.seq_block_ids(2).tolist() == m.seq_block_ids(0)[:1].tolist()


def test_never_matches_whole_prompt():
    m = mk()
    prompt = toks(2 * PS)
    m.allocate_for_seq(0, len(prompt))
    m.register_prefix(0, prompt, len(prompt))
    assert m.match_prefix(1, prompt) == PS   # one token must stay to prefill


def test_refcounts_and_leak_freedom():
    m = mk()
    free0 = m.num_free_blocks
    prompt = toks(9)
    m.allocate_for_seq(0, 9)
    m.register_prefix(0, prompt, 9)
    m.match_prefix(1, prompt)
    shared = m.seq_block_ids(1).tolist()
    m.free_seq(0)          # seq 1 still holds the shared pages
    m.match_prefix(2, prompt)
    assert m.seq_block_ids(2).tolist() == shared
    m.free_seq(1)
    m.free_seq(2)
    assert m.num_free_blocks == free0        # retired pages count as free
    assert m.match_prefix(3, prompt) == 2 * PS   # revived from the LRU
    m.free_seq(3)
    assert m.num_free_blocks == free0


def test_eviction_invalidates_descendants():
    m = mk(num_blocks=4)
    prompt = toks(3 * PS + 1)
    m.allocate_for_seq(0, len(prompt))
    m.register_prefix(0, prompt, len(prompt))
    m.free_seq(0)
    m.allocate_for_seq(1, 4 * PS)            # evicts the oldest retired page
    m.free_seq(1)
    assert m.match_prefix(2, prompt) == 0    # no stale-page match
    m.free_seq(2)
    assert m.num_free_blocks == 4


MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
          head_dim=16, ffn_inter_dim=128, vocab_size=256,
          max_position_embeddings=2048, rms_norm_eps=1e-5)
EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=16,
          num_hbm_blocks=64, num_cpu_blocks=0, max_blocks_per_seq=16,
          max_batch_size=8, max_tokens_in_batch=128, prefill_chunk_size=32,
          max_seqs_in_block_table=32, preemption_mode="recompute",
          use_pallas=True)


async def _serve_in_turn(engine, raws, timeout=120):
    """Each request after the previous one finished (so it can match it)."""
    loops = asyncio.create_task(engine.start_all_event_loops())
    try:
        out = []
        for r in raws:
            _, t = await asyncio.wait_for(engine.add_request_and_wait(r), timeout)
            out.append(list(t))
        return out
    finally:
        loops.cancel()


def test_engine_prefix_caching_shares_and_matches_uncached():
    prompt = "the quick brown fox jumps over the lazy dog " * 3

    async def run_with(enable):
        e = Engine(EngineConfig(**dict(EC, enable_prefix_caching=enable)),
                   LlamaModelConfig(**MC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        out = await _serve_in_turn(e, [RawRequest(prompt, 6), RawRequest(prompt, 6),
                                       RawRequest(prompt + " tail", 6)])
        return out, e

    on, eng_on = asyncio.run(run_with(True))
    off, eng_off = asyncio.run(run_with(False))
    assert on == off
    mgr = eng_on.model.hbm_block_mgrs[0]
    assert mgr._prefix_map
    assert eng_on.stats.num_prompt_tokens < eng_off.stats.num_prompt_tokens


def test_recompute_preemption_rides_prefix_cache():
    """Preempt-by-recompute victims re-prefill on re-admission and match
    their still-resident prompt pages; outputs equal an unpreempted run."""
    async def run_with(**cfg):
        e = Engine(EngineConfig(**dict(EC, prefill_chunk_size=16,
                                       max_tokens_in_batch=64,
                                       enable_prefix_caching=True, **cfg)),
                   LlamaModelConfig(**MC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        loops = asyncio.create_task(e.start_all_event_loops())
        try:
            outs = await asyncio.wait_for(asyncio.gather(*[
                e.add_request_and_wait(RawRequest(
                    "", 40, prompt_token_ids=[(i + j) % 256 for j in range(40)]))
                for i in range(2)]), 300)
        finally:
            loops.cancel()
        return [list(t) for _, t in outs], e

    tight, eng = asyncio.run(run_with(num_hbm_blocks=8, max_blocks_per_seq=8))
    assert eng.stats.num_preemptions >= 1
    roomy, eng2 = asyncio.run(run_with())
    assert eng2.stats.num_preemptions == 0
    assert tight == roomy


def test_prefix_caching_matches_hf_golden(tmp_path_factory):
    """A tiny HF Llama built locally: the first generation (registering its
    prompt pages) equals HF's greedy tokens; a second request matched onto
    those pages by hand generates the same tokens from its tail."""
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM

    from tests.test_llama_golden import hf_greedy
    from tests.test_torch_model import run_port

    path = tmp_path_factory.mktemp("tiny_llama_apc_port")
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      rms_norm_eps=1e-5)
    torch.manual_seed(3)
    hf = LlamaForCausalLM(cfg).eval()
    hf.save_pretrained(path, safe_serialization=True)

    m = LlamaModel(EngineConfig(model_path=str(path), dtype="float32",
                                block_size=4, max_blocks_per_seq=16,
                                max_tokens_in_batch=64, num_hbm_blocks=32,
                                prefill_chunk_size=8, preemption_mode="recompute",
                                enable_prefix_caching=True), device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    prompt = [1, 7, 3, 9, 11, 5, 2, 8, 6, 4]
    first = run_port(m, [prompt], 5)[0]
    assert first == hf_greedy(hf, prompt, 5)
    r = Request(RawRequest("", 5))
    r.set_prompt_token_ids(list(prompt))
    r.seq_id = 1
    assert m.match_prefix(r) == 8 and r.num_cached_tokens == 8
    outs = []

    def apply(tokens, rows):
        for i, s in enumerate(rows):
            if s is None:
                continue
            if s.samples_token:
                outs.append(int(tokens[i]))
                s.request.output_token_ids.append(int(tokens[i]))
            s.request.num_cached_tokens += s.n_tokens

    apply(*m.forward([ScheduledSeq(r, r.num_uncached_tokens())]))
    while len(outs) < 5:
        apply(*m.forward([ScheduledSeq(r, 1)]))
    assert outs == first


def test_engine_prefix_caching_matches_jax_engine():
    """Three requests in turn (a prompt, the same prompt, the prompt and a
    tail) through both engines: equal tokens, equal matched counts."""
    from tests.test_torch_engine import EC as PEC, MC as PMC
    ec = dict(PEC, enable_prefix_caching=True)
    jm = JaxLlamaModel(JaxEngineConfig(**PEC), JaxModelConfig(**PMC))
    jm.load_weights()
    tree = scaled_params(jm.params, np.random.default_rng(8))
    base = [(11 * j) % 250 + 1 for j in range(45)]
    prompts = [base, base, base + [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]]

    def matched_log(model):
        log = []
        real = model.match_prefix

        def spy(req):
            n = real(req)
            log.append(n)
            return n
        return log, spy

    async def jax_run():
        e = JaxEngine(JaxEngineConfig(**ec), JaxModelConfig(**PMC))
        await e.initialize(tokenizer_backend="inline")
        e.model.params = jax.tree.map(
            lambda old, new: jax.device_put(new, old.sharding), e.model.params, tree)
        log, e.scheduler.prefix_matcher = matched_log(e.model)
        out = await _serve_in_turn(e, [JaxRawRequest("", 8, prompt_token_ids=p)
                                       for p in prompts])
        return out, log

    async def port_run():
        e = Engine(EngineConfig(**ec), LlamaModelConfig(**PMC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        e.model.params = params_from_numpy(tree, "cpu")
        log, e.scheduler.prefix_matcher = matched_log(e.model)
        out = await _serve_in_turn(e, [RawRequest("", 8, prompt_token_ids=p)
                                       for p in prompts])
        return out, log

    want, want_log = asyncio.run(jax_run())
    got, got_log = asyncio.run(port_run())
    assert got == want
    assert got_log == want_log == [0, 32, 32]
