"""Swap preemption in the port, on the CPU.

- The engine under page pressure with ``preemption_mode="swap"``: the port of
  ``tests/test_engine.py::test_engine_preemption_swap``, whose tokens must
  equal a roomy run's (no preemption) and the JAX engine's swap run on the
  same parameters (``params_from_numpy``), exactly.
- The model's swap-out and swap-in: every page byte-equal after the round
  trip to other device pages, in bf16 and in fp8 (rows moved whole, scale
  lanes included), and the host pool's pages back afterwards.
- A request aborted while swapped out returns its host pages.
- The page mover's plain version (what ``swap_pages`` runs on CPU tensors,
  and what the card holds the CUDA kernel against) against a numpy page
  copy with the semantics of ``tests/test_native_page_copy.py``: scattered
  and consecutive pages, cache to pool and pool to cache; the same at the
  page shapes the engines swap (8B and Qwen2-0.5B widths, bf16 pages of 16
  rows and fp8 pages of 32 with their scale lanes); no launch but on a card.
- The default ``EngineConfig`` (swap, 2,048 host pages) builds a model and
  serves, with and without LoRA adapters.

The parameters of the engine runs are the JAX engine's dummy tree scaled to
O(0.1) weights (tests/test_torch_llama.py), so that greedy margins are far
above the f32 noise between the two packages.
"""

import asyncio

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
from swiftllm_tpu.server.engine import Engine as JaxEngine
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.ops.swap_pages import page_slots, swap_pages
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_llama import scaled_params

MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
          head_dim=16, ffn_inter_dim=128, vocab_size=256,
          max_position_embeddings=2048, rms_norm_eps=1e-5)
# tests/test_engine.py's tiny engine, with its swap test's page pressure: 8
# pages of 16 tokens, two requests of 40 prompt and 40 output tokens.
EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=16,
          num_hbm_blocks=64, num_cpu_blocks=64, max_blocks_per_seq=16,
          max_batch_size=8, max_tokens_in_batch=128, prefill_chunk_size=32,
          max_seqs_in_block_table=32, use_pallas=True)
TIGHT = dict(num_hbm_blocks=8, num_cpu_blocks=16, max_blocks_per_seq=8,
             prefill_chunk_size=16, max_tokens_in_batch=64)
PROMPTS = [[(i + j) % 256 for j in range(40)] for i in range(2)]
OUT_LEN = 40


async def serve(engine, raw_cls, prompts=PROMPTS, out_len=OUT_LEN):
    loops = asyncio.create_task(engine.start_all_event_loops())
    try:
        outs = await asyncio.wait_for(asyncio.gather(*[
            engine.add_request_and_wait(raw_cls("", out_len, prompt_token_ids=p))
            for p in prompts]), 300)
    finally:
        loops.cancel()
    return [list(toks) for _, toks in outs]


@pytest.fixture(scope="module")
def jax_swap_run():
    """The JAX engine's swap run on the scaled parameters: (tree, tokens)."""
    async def body():
        e = JaxEngine(JaxEngineConfig(**dict(EC, **TIGHT)), JaxModelConfig(**MC))
        await e.initialize(tokenizer_backend="inline")
        tree = scaled_params(e.model.params, np.random.default_rng(3))
        e.model.params = jax.tree.map(
            lambda old, new: jax.device_put(new, old.sharding), e.model.params, tree)
        toks = await serve(e, JaxRawRequest)
        assert e.stats.num_preemptions >= 1
        return tree, toks
    return asyncio.run(body())


async def port_engine(tree=None, **ec_kw):
    e = Engine(EngineConfig(**dict(EC, **ec_kw)), LlamaModelConfig(**MC),
               device="cpu")
    await e.initialize(tokenizer_backend="inline")
    if tree is not None:
        e.model.params = params_from_numpy(tree, "cpu")
    return e


@pytest.fixture(scope="module")
def port_swap_run(jax_swap_run):
    """The port's swap engine on the same parameters: (engine, tokens)."""
    tree, _ = jax_swap_run

    async def body():
        e = await port_engine(tree, **TIGHT)
        return e, await serve(e, RawRequest)
    return asyncio.run(body())


def test_engine_preemption_swap(port_swap_run):
    """tests/test_engine.py::test_engine_preemption_swap on the port: page
    pressure forces a swap-out, and both requests finish; both pools are
    full again afterwards."""
    e, toks = port_swap_run
    assert all(len(t) == OUT_LEN for t in toks)
    assert e.stats.num_preemptions >= 1, \
        "page pressure should have forced at least one swap-out"
    assert e.model.cpu_cache is not None
    assert e.model.hbm_block_mgrs[0].num_free_blocks == TIGHT["num_hbm_blocks"]
    assert e.model.cpu_block_mgr.num_free_blocks == TIGHT["num_cpu_blocks"]
    assert e.scheduler.num_free_cpu_blocks == TIGHT["num_cpu_blocks"]


def test_swap_tokens_match_roomy_run(jax_swap_run, port_swap_run):
    """A roomy engine (no preemption) gives the swap run's tokens."""
    tree, _ = jax_swap_run
    _, want = port_swap_run

    async def body():
        e = await port_engine(tree)
        return e, await serve(e, RawRequest)
    e, got = asyncio.run(body())
    assert e.stats.num_preemptions == 0
    assert got == want


def test_swap_tokens_match_jax(jax_swap_run, port_swap_run):
    """The port's swap run gives the JAX engine's swap run's tokens."""
    assert port_swap_run[1] == jax_swap_run[1]


TINY_MC = dict(num_layers=2, num_q_heads=2, num_kv_heads=1, hidden_size=16,
               head_dim=8, ffn_inter_dim=32, vocab_size=32,
               max_position_embeddings=256, rms_norm_eps=1e-5)


@pytest.mark.parametrize("kv_quant", ["none", "fp8"])
def test_swap_round_trip_pages_byte_equal(kv_quant):
    """swap_out_seqs then swap_in_seqs of two sequences: their pages come
    back byte-equal at other device pages (fp8 rows whole, scale lanes
    included), the pages they left are free, and so is the host pool."""
    bs = 32 if kv_quant == "fp8" else 16
    ec = EngineConfig(use_dummy=True, kv_quant=kv_quant, block_size=bs,
                      num_cpu_blocks=12, max_blocks_per_seq=8,
                      max_seqs_in_block_table=8)
    m = LlamaModel(ec, LlamaModelConfig(**TINY_MC), device="cpu")
    m.init_kvcache_and_swap(16)
    g = torch.Generator().manual_seed(5)
    raw = torch.randint(0, 256, m.kv_cache.shape[:2] + (m.kv_cache.shape[2]
                        * m.kv_cache.element_size(),), generator=g,
                        dtype=torch.uint8)
    m.kv_cache.view(torch.uint8).copy_(raw)
    assert m.cpu_cache.dtype == m.kv_cache.dtype
    mgr, cpu = m.hbm_block_mgrs[0], m.cpu_block_mgr
    reqs = []
    for i, n in enumerate([3 * bs + 5, 2 * bs]):
        r = Request(RawRequest("", 4))
        r.set_prompt_token_ids(list(range(n)))
        r.seq_id, r.num_cached_tokens = i, n
        mgr.allocate_for_seq(i, n)
        reqs.append(r)
    before = [m.kv_cache.view(torch.uint8)[:, page_slots(mgr.seq_block_ids(i), bs)]
              .clone() for i in range(2)]
    old = [set(mgr.seq_block_ids(i).tolist()) for i in range(2)]
    m.swap_out_seqs(reqs)
    assert mgr.num_free_blocks == 16
    assert cpu.num_free_blocks == 12 - 4 - 2
    # The six pages just freed go to another sequence (the free list is a
    # stack), so the swap-in lands on other pages.
    mgr.allocate_for_seq(5, 6 * bs)
    assert set(mgr.seq_block_ids(5).tolist()) == old[0] | old[1]
    m.swap_in_seqs(reqs)
    assert cpu.num_free_blocks == 12
    for i in range(2):
        pages = mgr.seq_block_ids(i)
        assert not set(pages.tolist()) & (old[0] | old[1])
        got = m.kv_cache.view(torch.uint8)[:, page_slots(pages, bs)]
        assert torch.equal(got, before[i]), f"sequence {i}"


def test_abort_while_swapped_frees_host_pages():
    """A request aborted while swapped out gives its host pages back (the
    model's pool and the scheduler's budget), and the other one finishes."""
    async def body():
        e = await port_engine(None, **TIGHT)
        loops = asyncio.create_task(e.start_all_event_loops())
        try:
            reqs = [e.submit(RawRequest("", OUT_LEN, prompt_token_ids=p))
                    for p in PROMPTS]
            t_end = asyncio.get_running_loop().time() + 120
            while not any(r.swapped for r in reqs):
                assert asyncio.get_running_loop().time() < t_end, "no swap-out"
                await asyncio.sleep(0.005)
            victim = next(r for r in reqs if r.swapped)
            held = e.model.cpu_block_mgr.num_free_blocks
            assert held < TIGHT["num_cpu_blocks"]
            e.abort_request(victim)
            other = next(r for r in reqs if r is not victim)
            await asyncio.wait_for(other.finished_event.wait(), 120)
            while e.model.cpu_block_mgr.num_free_blocks != TIGHT["num_cpu_blocks"]:
                assert asyncio.get_running_loop().time() < t_end, "pages not back"
                await asyncio.sleep(0.005)
        finally:
            loops.cancel()
        return e, victim, other
    e, victim, other = asyncio.run(body())
    assert victim.aborted and len(other.output_token_ids) == OUT_LEN
    assert e.scheduler.num_free_cpu_blocks == TIGHT["num_cpu_blocks"]


def _ref_copy(dst, src, dst_pages, src_pages, slots_per_page):
    """tests/test_native_page_copy.py's numpy page copy."""
    for dp, sp in zip(dst_pages, src_pages):
        dst[:, dp * slots_per_page:(dp + 1) * slots_per_page] = \
            src[:, sp * slots_per_page:(sp + 1) * slots_per_page]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("direction", ["cache_to_pool", "pool_to_cache"])
@pytest.mark.parametrize("layout", ["scattered", "consecutive"])
def test_mover_plain_matches_page_copy(layout, direction, dtype):
    """swap_pages on CPU tensors (its plain version) moves exactly the named
    pages of every layer and nothing else, bytes unchanged."""
    rng = np.random.default_rng(0)
    L, spp, W, n_cache, n_pool = 3, 4, 24, 32, 24
    cache = torch.from_numpy(rng.integers(0, 256, (L, n_cache * spp, W * 2),
                                          dtype=np.uint8))
    pool = torch.from_numpy(rng.integers(0, 256, (L, n_pool * spp, W * 2),
                                         dtype=np.uint8))
    src_t, dst_t = (cache, pool) if direction == "cache_to_pool" else (pool, cache)
    n_src, n_dst = src_t.shape[1] // spp, dst_t.shape[1] // spp
    if layout == "scattered":
        src_pages = rng.permutation(n_src)[:16]
        dst_pages = rng.permutation(n_dst)[:16]
    else:
        src_pages, dst_pages = np.arange(4, 20), np.arange(2, 18)
    want = dst_t.numpy().copy()
    _ref_copy(want, src_t.numpy(), dst_pages, src_pages, spp)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    src = src_t.view(dtype)
    dst = dst_t.clone().view(dtype)
    assert src.shape[2] == 2 * W // itemsize
    swap_pages(src, dst, src_pages, dst_pages, spp)
    np.testing.assert_array_equal(dst.view(torch.uint8).numpy(), want)


def test_mover_checks_its_pages():
    """A page outside either side, or a destination named twice, raises
    before anything moves."""
    a = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    b = torch.zeros(2, 12, 16, dtype=torch.bfloat16)
    with pytest.raises(IndexError):
        swap_pages(a, b, [0, 2], [0, 3], 4)       # b has pages 0..2
    with pytest.raises(IndexError):
        swap_pages(a, b, [2], [0], 4)             # a has pages 0, 1
    with pytest.raises(ValueError, match="twice"):
        swap_pages(a, b, [0, 1], [1, 1], 4)
    with pytest.raises(TypeError):
        swap_pages(a, b.float(), [0], [0], 4)


# (row lanes, element type, rows a page) of the pages the engines swap: K
# and V of every kv head a row (8B: 8 of 128; Qwen2-0.5B: 2 of 64), bf16
# pages of 16 rows, fp8 rows of e4m3 bytes ending in 128 scale lanes in
# pages of 32.
PAGE_SHAPES = {"8B bf16": (2 * 8 * 128, torch.bfloat16, 16),
               "8B fp8": (2 * 8 * 128 + 128, torch.float8_e4m3fn, 32),
               "Qwen2-0.5B bf16": (2 * 2 * 64, torch.bfloat16, 16),
               "Qwen2-0.5B fp8": (2 * 2 * 64 + 128, torch.float8_e4m3fn, 32)}


@pytest.mark.parametrize("layout", ["scattered", "consecutive"])
@pytest.mark.parametrize("kv", list(PAGE_SHAPES))
def test_mover_plain_at_model_pages(kv, layout):
    """The mover's plain version at the page shapes the card moves (what
    chip_smoke.py holds the kernel to, byte for byte): 6 of 12 cache pages
    out to 6 of 10 pool pages and back in to other cache pages, two layers;
    every named page equal to its source and every other byte unchanged."""
    lanes, dtype, spp = PAGE_SHAPES[kv]
    rng = np.random.default_rng(7)
    itemsize = torch.empty(0, dtype=dtype).element_size()
    cache = torch.from_numpy(rng.integers(0, 256, (2, 12 * spp, lanes * itemsize),
                                          dtype=np.uint8))
    pool = torch.from_numpy(rng.integers(0, 256, (2, 10 * spp, lanes * itemsize),
                                         dtype=np.uint8))
    if layout == "scattered":
        out, host = rng.permutation(12)[:6], rng.permutation(10)[:6]
        back = rng.permutation(np.setdiff1d(np.arange(12), out))[:6]
    else:
        out, host, back = np.arange(1, 7), np.arange(3, 9), np.arange(6, 12)
    want_pool = pool.numpy().copy()
    _ref_copy(want_pool, cache.numpy(), host, out, spp)
    want_cache = cache.numpy().copy()
    _ref_copy(want_cache, want_pool, back, host, spp)
    swap_pages(cache.view(dtype), pool.view(dtype), out, host, spp)
    np.testing.assert_array_equal(pool.numpy(), want_pool)
    swap_pages(pool.view(dtype), cache.view(dtype), host, back, spp)
    np.testing.assert_array_equal(cache.numpy(), want_cache)


def test_mover_launches_or_raises_off_the_cpu():
    """Off the CPU the mover launches its kernel or raises: tensors on a
    device it cannot launch on, or an unpinned host side beside one, are
    refused, never moved by the plain version."""
    a = torch.zeros(2, 8, 16, dtype=torch.bfloat16, device="meta")
    b = torch.zeros(2, 8, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="pinned"):
        swap_pages(a, b, [0], [1], 4)
    with pytest.raises(ValueError, match="pinned"):
        swap_pages(torch.zeros(2, 8, 16, dtype=torch.bfloat16), b, [0], [1], 4)


@pytest.mark.parametrize("lora", ["", "dummy:a,b"], ids=["base", "lora"])
def test_default_engine_config_builds_and_serves(lora):
    """The default EngineConfig (swap with 2,048 host pages, 128 rows,
    2,048-token steps) builds a model with its host pool and serves, with
    and without adapters; only the page count is set (the CPU has no card
    to size it by) and dummy weights."""
    ec = EngineConfig(use_dummy=True, num_hbm_blocks=64, lora_paths=lora)
    assert ec.preemption_mode == "swap" and ec.num_cpu_blocks == 2048

    async def body():
        e = Engine(ec, LlamaModelConfig(**TINY_MC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        assert tuple(e.model.cpu_cache.shape) == (2, 2048 * 16, 16)
        assert e.model.lora_slots == ({"a": 1, "b": 2} if lora else {})
        prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
        return await serve(e, RawRequest, prompts, 4)
    toks = asyncio.run(body())
    assert all(len(t) == 4 and all(0 <= x < 32 for x in t) for t in toks)
