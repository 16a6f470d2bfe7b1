"""The PyTorch port serving at tp/dp > 1 on the CPU, one process per rank
over gloo, against the JAX package and HF transformers.

- dp = 2 x tp = 2 (four ranks): the Engine on rank 0 warms up (its steps
  on dp group 0 alone), pins requests to dp groups at admission, three
  followers replay every step, and the tokens
  equal the JAX engine's at dp = 2 x tp = 2 on the same parameters
  (``tests/test_engine.py::test_engine_dp_serving``'s engine), exactly (f32
  on both sides; the greedy margins of these weights are far above the
  all-reduce's rounding). Every group's pages and ids come back.
- Multi-step decode (S = 4) at dp = 2 x tp = 2, fused and in deferred-commit
  mode (``SWIFTLLM_DEFER_KV=1``): every inner step's collectives pair up
  across ranks, the engine reads the [dp * B * S] token layout, and the
  tokens equal the JAX engine's multi-step run at dp = 2 x tp = 2, exactly.
- Swap preemption at tp = 2 under page pressure (``tests/test_torch_swap.py``'s
  tight pools): the follower replays the swap-outs and swap-ins on its own
  shard's lanes and pool, and the tokens equal the JAX engine's swap run at
  tp = 2. A request aborted while swapped out gives its host pages back on
  every rank (the follower replays the free).
- LoRA at tp = 2 (``tests/test_lora.py``'s mixed batch): a base row and two
  adapter rows against HF with each adapter merged, atol 5e-4 / rtol 2e-3
  (the JAX test's tolerance).
- Qwen2 at tp = 4 > num_kv_heads = 2 (``tests/test_qwen2_golden.py``'s
  tied-embedding checkpoint with q/k/v biases): KV heads and their biases
  replicated, greedy tokens equal HF's.

Every spawned rank has a join timeout and is killed after it.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.parallel import distributed
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_parallel import _jax_model, run_ranks, scaled_tree

MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
          head_dim=16, ffn_inter_dim=128, vocab_size=256,
          max_position_embeddings=2048, rms_norm_eps=1e-5)
# tests/test_engine.py's tiny engine in f32.
EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=16,
          num_hbm_blocks=32, num_cpu_blocks=0, max_blocks_per_seq=16,
          max_batch_size=4, max_tokens_in_batch=128, prefill_chunk_size=32,
          max_seqs_in_block_table=32, use_pallas=True)
DP_PROMPTS = [[(3 * i + j) % 256 for j in range(10 + i)] for i in range(6)]
DP_OUT = 6
# tests/test_torch_swap.py's page pressure: 8 pages of 16 tokens, two
# requests of 40 prompt and 40 output tokens.
TIGHT = dict(num_hbm_blocks=8, num_cpu_blocks=16, max_blocks_per_seq=8,
             prefill_chunk_size=16, max_tokens_in_batch=64, max_batch_size=8,
             preemption_mode="swap")
SWAP_PROMPTS = [[(i + j) % 256 for j in range(40)] for i in range(2)]
SWAP_OUT = 40


async def _serve(engine, raw_cls, prompts, out_len):
    loops = asyncio.create_task(engine.start_all_event_loops())
    try:
        outs = await asyncio.wait_for(asyncio.gather(*[
            engine.add_request_and_wait(raw_cls("", out_len, prompt_token_ids=p))
            for p in prompts]), 120)
    finally:
        loops.cancel()
        try:
            await loops
        except asyncio.CancelledError:
            pass
    return outs


def _jax_engine_run(ec_kw, prompts, out_len, seed):
    """The JAX engine's tokens on the scaled tree: (tree, tokens, stats)."""
    import jax
    from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
    from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
    from swiftllm_tpu.server.engine import Engine as JaxEngine
    from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest

    async def body():
        e = JaxEngine(JaxEngineConfig(**dict(EC, use_pallas=False, **ec_kw)),
                      JaxModelConfig(**MC))
        await e.initialize(tokenizer_backend="inline")
        tree = scaled_tree(e.model.params, np.random.default_rng(seed))
        e.model.params = jax.tree.map(
            lambda old, new: jax.device_put(new, old.sharding),
            e.model.params, tree)
        outs = await _serve(e, JaxRawRequest, prompts, out_len)
        return tree, [list(t) for _, t in outs], e.stats.snapshot()
    return asyncio.run(body())


def _engine_rank(rank, ec_kw, tree, prompts, out_len, warmup=False):
    """Rank 0 serves ``prompts`` through the Engine (after its warm-up with
    ``warmup``) and counts its steps; the others follow and count the ops
    they replay."""
    ec = EngineConfig(**dict(EC, **ec_kw))
    mc = LlamaModelConfig(**MC)
    if distributed.is_primary():
        async def body():
            e = Engine(ec, mc, device="cpu")
            await e.initialize(tokenizer_backend="inline")
            m = e.model
            m.params = params_from_numpy(tree, "cpu", m.mesh.tp_rank, m.tp)
            executed = []
            real = m.execute_packed

            def count(*a):
                executed.append(a[1].steps)
                return real(*a)
            m.execute_packed = count
            if warmup:
                await e.warmup()
            outs = await _serve(e, RawRequest, prompts, out_len)
            return dict(
                executed=len(executed), steps=sorted(set(executed)),
                tokens=[list(t) for _, t in outs],
                groups=[r.dp_group for r, _ in outs],
                stats=e.stats.snapshot(),
                free=[g.num_free_blocks for g in m.hbm_block_mgrs],
                ids=[len(g.available_ids) for g in e.scheduler.id_managers],
                cpu_free=m.cpu_block_mgr.num_free_blocks)
        return asyncio.run(body())
    return _follow(ec, mc, tree)


def _follow(ec, mc, tree):
    """A follower rank: replay the primary's ops until it stops; the ops it
    saw and its host pool's free pages."""
    m = LlamaModel(ec, mc, device="cpu")
    m.load_weights()
    m.params = params_from_numpy(tree, "cpu", m.mesh.tp_rank, m.tp)
    m.init_kvcache_and_swap()
    ops = []
    real = distributed.exchange_op

    def logged(*a, **kw):
        out = real(*a, **kw)
        ops.append(out[0])
        return out
    distributed.exchange_op = logged
    distributed.follower_loop(m)
    return dict(ops=ops, cpu_free=m.cpu_block_mgr.num_free_blocks)


def test_engine_dp2_tp2_matches_jax(tmp_path):
    kw = dict(dp_size=2, tp_size=2)
    tree, want, _ = _jax_engine_run(kw, DP_PROMPTS, DP_OUT, seed=1)
    # The primary's warm-up runs too (its steps on dp group 0 alone).
    primary, *followers = run_ranks(_engine_rank, 4, kw, tree, DP_PROMPTS,
                                    DP_OUT, True, tmp_path=tmp_path)
    assert primary["tokens"] == want
    assert all(len(t) == DP_OUT for t in primary["tokens"])
    assert set(primary["groups"]) == {0, 1}, \
        "admission should spread requests across both dp groups"
    assert primary["free"] == [EC["num_hbm_blocks"]] * 2
    assert primary["ids"] == [EC["max_seqs_in_block_table"]] * 2
    assert primary["executed"] > primary["stats"]["num_steps"]   # warm-up
    for f in followers:
        assert f["ops"][-1] == distributed.OP_STOP
        assert f["ops"].count(distributed.OP_STEP) == primary["executed"]


@pytest.mark.parametrize("defer", ["0", "1"], ids=["fused", "deferred"])
def test_engine_dp2_tp2_multi_step_matches_jax(defer, monkeypatch, tmp_path):
    # The spawned ranks inherit the variable; the JAX engine runs its plain
    # path, which never defers (its tokens are the fused mode's).
    monkeypatch.setenv("SWIFTLLM_DEFER_KV", defer)
    kw = dict(dp_size=2, tp_size=2, multi_step_decode=4)
    tree, want, _ = _jax_engine_run(kw, DP_PROMPTS, DP_OUT, seed=1)
    primary, *followers = run_ranks(_engine_rank, 4, kw, tree, DP_PROMPTS,
                                    DP_OUT, tmp_path=tmp_path)
    assert primary["tokens"] == want
    assert all(len(t) == DP_OUT for t in primary["tokens"])
    assert set(primary["groups"]) == {0, 1}
    assert 4 in primary["steps"], "no multi-step window was dispatched"
    assert primary["stats"]["num_steps"] < primary["stats"]["num_tokens_generated"]
    assert primary["free"] == [EC["num_hbm_blocks"]] * 2
    for f in followers:
        assert f["ops"][-1] == distributed.OP_STOP
        assert f["ops"].count(distributed.OP_STEP) == primary["executed"]


def test_engine_swap_tp2_matches_jax(tmp_path):
    kw = dict(TIGHT, tp_size=2)
    tree, want, jax_stats = _jax_engine_run(kw, SWAP_PROMPTS, SWAP_OUT, seed=3)
    assert jax_stats["num_preemptions"] >= 1
    primary, follower = run_ranks(_engine_rank, 2, kw, tree, SWAP_PROMPTS,
                                  SWAP_OUT, tmp_path=tmp_path)
    assert primary["tokens"] == want
    assert primary["stats"]["num_preemptions"] >= 1
    ops = follower["ops"]
    assert ops.count(distributed.OP_SWAP_OUT) >= 1
    assert ops.count(distributed.OP_SWAP_IN) >= 1
    # Both ranks' host allocators end full: they stayed in step (one op
    # may move several requests, so the op counts need not match).
    assert primary["cpu_free"] == follower["cpu_free"] == TIGHT["num_cpu_blocks"]
    assert primary["free"] == [TIGHT["num_hbm_blocks"]]


def _abort_rank(rank, tree):
    """Rank 0 aborts a request while it is swapped out (the method of
    tests/test_torch_swap.py::test_abort_while_swapped_frees_host_pages);
    the follower replays every op."""
    ec = EngineConfig(**dict(EC, **TIGHT, tp_size=2))
    mc = LlamaModelConfig(**MC)
    if not distributed.is_primary():
        return _follow(ec, mc, tree)

    async def body():
        e = Engine(ec, mc, device="cpu")
        await e.initialize(tokenizer_backend="inline")
        m = e.model
        m.params = params_from_numpy(tree, "cpu", m.mesh.tp_rank, m.tp)
        loop = asyncio.get_running_loop()
        loops = asyncio.create_task(e.start_all_event_loops())
        try:
            reqs = [e.submit(RawRequest("", SWAP_OUT, prompt_token_ids=p))
                    for p in SWAP_PROMPTS]
            t_end = loop.time() + 120
            while not any(r.swapped for r in reqs):
                assert loop.time() < t_end, "no swap-out"
                await asyncio.sleep(0.005)
            victim = next(r for r in reqs if r.swapped)
            held = m.cpu_block_mgr.num_free_blocks
            e.abort_request(victim)
            other = next(r for r in reqs if r is not victim)
            await asyncio.wait_for(other.finished_event.wait(), 120)
            while m.cpu_block_mgr.num_free_blocks != TIGHT["num_cpu_blocks"]:
                assert loop.time() < t_end, "host pages not back"
                await asyncio.sleep(0.005)
        finally:
            loops.cancel()
            try:
                await loops
            except asyncio.CancelledError:
                pass
        return dict(held=held, aborted=victim.aborted,
                    other=len(other.output_token_ids),
                    cpu_free=m.cpu_block_mgr.num_free_blocks,
                    budget=e.scheduler.num_free_cpu_blocks)
    return asyncio.run(body())


def test_abort_while_swapped_tp2_frees_every_ranks_pages(tmp_path):
    tree = scaled_tree(_jax_model({}, MC).params, np.random.default_rng(3))
    primary, follower = run_ranks(_abort_rank, 2, tree, tmp_path=tmp_path)
    assert primary["held"] < TIGHT["num_cpu_blocks"]
    assert primary["aborted"] and primary["other"] == SWAP_OUT
    assert distributed.OP_SWAP_FREE in follower["ops"]
    assert follower["ops"][-1] == distributed.OP_STOP
    assert primary["cpu_free"] == follower["cpu_free"] == TIGHT["num_cpu_blocks"]
    assert primary["budget"] == TIGHT["num_cpu_blocks"]


# --- checkpoints at tp > 1 against HF ----------------------------------------------

def _port_ckpt_model(path, tp, **kw):
    ec = EngineConfig(model_path=str(path), dtype="float32", block_size=4,
                      max_blocks_per_seq=16, max_tokens_in_batch=64,
                      num_hbm_blocks=32, prefill_chunk_size=8,
                      preemption_mode="recompute", use_pallas=True,
                      tp_size=tp, **kw)
    m = LlamaModel(ec, device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    return m


def _lora_rank(rank, root, prompt):
    m = _port_ckpt_model(root / "base", 2,
                         lora_paths=f"a1={root / 'a1'},a2={root / 'a2'}")
    if not distributed.is_primary():
        distributed.follower_loop(m)
        return None
    reqs = []
    for i, slot in enumerate([0, 1, 2]):
        r = Request(RawRequest("", 1))
        r.set_prompt_token_ids(list(prompt))
        r.seq_id, r.lora_slot = i, slot
        reqs.append(r)
    _, _, logits = m.forward([ScheduledSeq(r, r.prompt_len) for r in reqs],
                             return_logits=True)
    distributed.stop_followers()
    return dict(slots=m.lora_slots, logits=logits[:3])


def test_lora_tp2_matches_merged_hf(lora_setup, tmp_path):  # noqa: F811
    import torch

    from tests.test_lora import _merged_hf
    root, hf, _ = lora_setup
    prompt = [1, 7, 3, 9, 11, 5]
    got = run_ranks(_lora_rank, 2, root, prompt, tmp_path=tmp_path)[0]
    assert got["slots"] == {"a1": 1, "a2": 2}
    expected = [hf, _merged_hf(hf, root / "a1"), _merged_hf(hf, root / "a2")]
    with torch.no_grad():
        for i, em in enumerate(expected):
            want = em(torch.tensor([prompt])).logits[0, -1].numpy()
            np.testing.assert_allclose(got["logits"][i][:len(want)], want,
                                       atol=5e-4, rtol=2e-3,
                                       err_msg=f"row {i} (tp=2)")


def _greedy(m, prompts, n):
    """Whole prompts, then greedy decode steps: n tokens a prompt."""
    reqs = []
    for i, p in enumerate(prompts):
        r = Request(RawRequest("", n))
        r.set_prompt_token_ids(list(p))
        r.seq_id = i
        reqs.append(r)
    sched = [ScheduledSeq(r, r.prompt_len) for r in reqs]
    while sched:
        tokens, rows = m.forward(sched)
        for i, s in enumerate(rows):
            if s is not None:
                s.request.output_token_ids.append(int(tokens[i]))
                s.request.num_cached_tokens += s.n_tokens
        sched = [ScheduledSeq(r, 1) for r in reqs if not r.is_finished()]
    return [r.output_token_ids for r in reqs]


def _qwen2_rank(rank, path, prompts, n):
    m = _port_ckpt_model(path, 4)
    if not distributed.is_primary():
        distributed.follower_loop(m)
        return None
    out = _greedy(m, prompts, n)
    distributed.stop_followers()
    return dict(tokens=out, lanes=m.kv_cache.shape[2], nkv=m.num_kv_eff)


def test_qwen2_tp4_matches_hf(tiny_qwen2, tmp_path):  # noqa: F811
    from tests.test_llama_golden import hf_greedy
    from tests.test_qwen2_golden import PROMPTS
    path, hf_model = tiny_qwen2
    got = run_ranks(_qwen2_rank, 4, path, PROMPTS, 6, tmp_path=tmp_path)[0]
    assert got["nkv"] == 4 and got["lanes"] == 2 * 1 * 16
    for p, o in zip(PROMPTS, got["tokens"]):
        assert o == hf_greedy(hf_model, p, 6), f"prompt {p}: {o}"


@pytest.fixture(scope="module")
def lora_setup(tmp_path_factory):
    from tests.test_lora import lora_setup as make
    return make.__wrapped__(tmp_path_factory)


@pytest.fixture(scope="module")
def tiny_qwen2(tmp_path_factory):
    from tests.test_qwen2_golden import tiny_qwen2 as make
    return make.__wrapped__(tmp_path_factory)
