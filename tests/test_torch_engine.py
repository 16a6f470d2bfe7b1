"""The port's Engine against the JAX package's Engine, on the CPU: the same
configuration (dummy tokenizer, recompute preemption, f32) and the same
parameters, five concurrent requests, one of them longer than the prefill
chunk. Greedy tokens must be equal, exactly; the pages must all return to
the pool. One request then goes through the port's real ``/generate`` over
aiohttp on localhost.

The parameters are the JAX engine's dummy tree scaled to O(0.1) weights
(see tests/test_torch_llama.py), so that greedy margins are far above the
f32 noise between the two packages.
"""

import asyncio

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
from swiftllm_tpu.server.engine import Engine as JaxEngine
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.structs import RawRequest
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_llama import scaled_params

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from swiftllm_tpu_torch.server.api_server import build_app  # noqa: E402

MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
          head_dim=16, ffn_inter_dim=128, vocab_size=256,
          max_position_embeddings=2048, rms_norm_eps=1e-5)
EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=16,
          num_hbm_blocks=64, max_blocks_per_seq=16, max_batch_size=8,
          max_tokens_in_batch=128, prefill_chunk_size=32,
          max_seqs_in_block_table=32, preemption_mode="recompute",
          use_pallas=False)
PROMPTS = [[(i * 7 + j * 3) % 255 + 1 for j in range(n)]
           for i, n in enumerate([5, 12, 70, 3, 21])]   # 70 > the 32 chunk
OUT_LEN = 6


async def serve(engine, raw_cls):
    loops = asyncio.create_task(engine.start_all_event_loops())
    try:
        outs = await asyncio.wait_for(asyncio.gather(*[
            engine.add_request_and_wait(raw_cls("", OUT_LEN, prompt_token_ids=p))
            for p in PROMPTS]), 120)
    finally:
        loops.cancel()
    return [list(toks) for _, toks in outs]


@pytest.fixture(scope="module")
def jax_run():
    async def body():
        e = JaxEngine(JaxEngineConfig(**EC), JaxModelConfig(**MC))
        await e.initialize(tokenizer_backend="inline")
        tree = scaled_params(e.model.params, np.random.default_rng(1))
        e.model.params = jax.tree.map(
            lambda old, new: jax.device_put(new, old.sharding), e.model.params, tree)
        return tree, await serve(e, JaxRawRequest)
    return asyncio.run(body())


async def port_engine(tree, use_pallas):
    e = Engine(EngineConfig(**dict(EC, use_pallas=use_pallas)),
               LlamaModelConfig(**MC), device="cpu")
    await e.initialize(tokenizer_backend="inline")
    e.model.params = params_from_numpy(tree, "cpu")
    return e


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_engine_tokens_match_jax(jax_run, use_pallas):
    tree, want = jax_run

    async def body():
        e = await port_engine(tree, use_pallas)
        free0 = e.model.hbm_block_mgrs[0].num_free_blocks
        got = await serve(e, RawRequest)
        return got, free0, e.model.hbm_block_mgrs[0].num_free_blocks
    got, free0, free1 = asyncio.run(body())
    assert got == want
    assert all(len(t) == OUT_LEN for t in got)
    assert free1 == free0 == EC["num_hbm_blocks"]


def test_generate_over_http(jax_run):
    tree, want = jax_run

    async def body():
        e = await port_engine(tree, True)
        loops = asyncio.create_task(e.start_all_event_loops())
        client = TestClient(TestServer(build_app(e)))
        await client.start_server()
        try:
            resp = await client.post("/generate", json={
                "prompt_token_ids": PROMPTS[2], "output_len": OUT_LEN,
                "decode": True})
            assert resp.status == 200
            return await resp.json()
        finally:
            await client.close()
            loops.cancel()
    data = asyncio.run(body())
    assert data["output_token_ids"] == want[2]
    assert isinstance(data["output"], str)


def test_temperature_refused_at_admission(jax_run):
    """Once refused at admission, now admitted and served: a request with
    temperature > 0 gets the tokens the model-level sampled steps give (the
    same per-position seeds), which differ from the greedy ones."""
    from swiftllm_tpu_torch.config import EngineConfig as EC_
    from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
    from swiftllm_tpu_torch.server.structs import Request
    from swiftllm_tpu_torch.worker.model import LlamaModel
    tree, want_greedy = jax_run
    kw = dict(temperature=0.7, top_k=30, top_p=0.95, seed=11)

    async def body():
        e = await port_engine(tree, True)
        req = e.submit(RawRequest("", OUT_LEN, prompt_token_ids=PROMPTS[1], **kw))
        assert not req.aborted
        loops = asyncio.create_task(e.start_all_event_loops())
        try:
            await asyncio.wait_for(req.finished_event.wait(), 120)
        finally:
            loops.cancel()
        return list(req.output_token_ids)
    got = asyncio.run(body())

    m = LlamaModel(EC_(**dict(EC, use_pallas=True)), LlamaModelConfig(**MC),
                   device="cpu")
    m.params = params_from_numpy(tree, "cpu")
    m.init_kvcache_and_swap()
    r = Request(RawRequest("", OUT_LEN, **kw))
    r.set_prompt_token_ids(PROMPTS[1])
    r.seq_id = 0
    while not r.is_finished():
        n = r.num_uncached_tokens()
        tokens, _ = m.forward([ScheduledSeq(r, n)])
        r.output_token_ids.append(int(tokens[0]))
        r.num_cached_tokens += n
    assert got == r.output_token_ids
    assert len(got) == OUT_LEN and got != want_greedy[1]
