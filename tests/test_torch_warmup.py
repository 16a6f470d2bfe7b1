"""The port's default warm-up (``server/engine.py:Engine.warmup``) against
what serving meets, on the CPU.

The JAX engine's warm-up runs every step shape greedy and sampled, so that
no request compiles a program while serving. The port's counterpart of a
compiled program is a CUDA graph, keyed by the bucket and by the attention
plans of the step's live rows (``worker/graphs.py:graph_key``). These tests
drive the engine with the stand-in capture of ``tests/test_torch_graphs.py``
(``rerun_capture``: a replay runs the step again on the graph's static
buffers), and hold:

- after ``warmup()``, greedy and sampled requests are served with no graph
  captured (the table does not grow, ``graphs.first_use`` stays 0), the
  greedy tokens equal the JAX engine's and the sampled ones an eager
  engine's on the same parameters;
- the warm-up captured every plan of every bucket its steps ran, and those
  buckets are ``warmup_buckets``' (which the memory profile budgets for);
- a planted fault, a warm-up whose sampled pass is patched out, captures a
  sampled key while serving;
- where steps run eagerly, ``warmup()`` runs its steps and returns, and
  ``warmup(bucket_keys)`` still raises.

The CPU has no SMs and its plain versions never split, so every plan would
be one split: ``LlamaModel._graph_key_args`` is patched to a card of 4 SMs.
At these widths (2 KV heads, 8 rows) the 132 SMs of an H100 still give one
plan a bucket; 4 SMs and a pages bucket of 64 give 4 or 5, as 132 SMs give
15 or 16 over 128 rows at 8B widths. Inputs come from fixed seeds.
"""

import asyncio
import dataclasses
import gc
import itertools

import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server import engine as engine_mod
from swiftllm_tpu_torch.server.engine import Engine, warmup_buckets
from swiftllm_tpu_torch.server.structs import RawRequest
from swiftllm_tpu_torch.worker import graphs
from swiftllm_tpu_torch.worker.batch_builder import select_buckets
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_engine import EC, MC, OUT_LEN, PROMPTS, jax_run, serve  # noqa: F401
from tests.test_torch_graphs import rerun_capture

N_SMS = 4
# A pages bucket of 64 (1,024 keys a row): the decode kernel's plan splits
# a row in up to 4 and the prefill kernel's in up to 8, so plans vary with
# the live rows.
WEC = dict(EC, use_pallas=True, max_blocks_per_seq=64)
SAMPLED = dict(temperature=0.8, top_k=20)


@pytest.fixture
def sms(monkeypatch):
    """Graph keys planned for a card of N_SMS SMs."""
    real = LlamaModel._graph_key_args
    monkeypatch.setattr(LlamaModel, "_graph_key_args",
                        lambda self: dict(real(self), n_sms=N_SMS))


async def _engine(tree, ec_kw=None, stand_in=True):
    e = Engine(EngineConfig(**dict(WEC, **(ec_kw or {}))),
               LlamaModelConfig(**MC), device="cpu")
    await e.initialize(tokenizer_backend="inline")
    e.model.params = params_from_numpy(tree, "cpu")
    if stand_in:
        e.model.graphs = graphs.StepGraphs("cpu", capture=rerun_capture)
    return e


async def _serve_sampled(engine):
    """The test prompts at temperature 0.8, top-k 20, seeds 100, 101, ...;
    their output tokens."""
    loops = asyncio.create_task(engine.start_all_event_loops())
    try:
        outs = await asyncio.wait_for(asyncio.gather(*[
            engine.add_request_and_wait(RawRequest(
                "", OUT_LEN, prompt_token_ids=p, seed=100 + i, **SAMPLED))
            for i, p in enumerate(PROMPTS)]), 120)
    finally:
        loops.cancel()
    return [list(toks) for _, toks in outs]


def _ran_buckets(model) -> list:
    """Spy on ``model.execute_packed``: the buckets of the steps it runs."""
    keys, execute = [], model.execute_packed

    def spy(flat, key, *a):
        keys.append(key)
        return execute(flat, key, *a)
    model.execute_packed = spy
    return keys


def test_warmed_engine_serves_without_capturing(jax_run, sms):
    """After ``warmup()``: every plan of every bucket the warm-up ran is
    captured, greedy and sampled; the greedy requests then give the JAX
    engine's tokens and the sampled ones an eager engine's, with no graph
    captured while serving; pages and ids are all back."""
    tree, want = jax_run

    async def body():
        e = await _engine(tree)
        mgr, ids = e.model.hbm_block_mgrs[0], e.scheduler.id_managers[0]
        free0, ids0 = mgr.num_free_blocks, len(ids.available_ids)
        ran = _ran_buckets(e.model)
        await e.warmup()
        g = e.model.graphs
        warmed = dict(g.table)
        assert (mgr.num_free_blocks, len(ids.available_ids)) == (free0, ids0)
        assert g.first_use == 0 and not g.warming
        buckets = warmup_buckets(e.engine_config)
        assert set(ran) == set(buckets)
        assert {k.bucket.sampling for k in warmed} == {0, 1}
        plans = {k: e.model._plan_keys(k) for k in buckets}
        assert set(warmed) == {gk for p in plans.values() for gk in p}
        assert len(warmed) > len(buckets)          # plans vary with live rows
        assert all(len(p) > 1 for p in plans.values())
        got = await serve(e, RawRequest)
        assert e.model.graphs.table == warmed and g.first_use == 0
        sampled = await _serve_sampled(e)
        assert e.model.graphs.table == warmed and g.first_use == 0
        assert sum(v.replays for v in warmed.values()) > 0
        assert any(v.replays for k, v in warmed.items() if k.bucket.sampling)
        eager = await _engine(tree, stand_in=False)
        assert eager.model.graphs is None
        return got, sampled, await _serve_sampled(eager)
    got, sampled, sampled_eager = asyncio.run(body())
    assert got == want
    assert sampled == sampled_eager and sampled != want


def test_greedy_only_warmup_is_caught(jax_run, sms, monkeypatch):
    """A planted fault: with the warm-up's sampled pass patched out, the
    greedy requests still capture nothing, but the sampled requests first
    use sampled keys while serving, and the counts say so."""
    tree, _ = jax_run
    monkeypatch.setattr(engine_mod, "WARMUP_TEMPERATURES", (0.0,))

    async def body():
        e = await _engine(tree)
        await e.warmup()
        g = e.model.graphs
        warmed = dict(g.table)
        assert {k.bucket.sampling for k in warmed} == {0}
        await serve(e, RawRequest)
        assert g.table == warmed and g.first_use == 0
        await _serve_sampled(e)
        new = set(g.table) - set(warmed)
        return g.first_use, new
    first_use, new = asyncio.run(body())
    assert first_use == len(new) > 0
    assert all(k.bucket.sampling for k in new)


def test_eager_model_warms_up_without_graphs(jax_run):
    """Where steps run eagerly (the CPU by rule): ``warmup()`` runs every
    step of both passes, captures nothing, releases pages and ids, and
    returns; ``warmup(bucket_keys)`` raises, as before."""
    tree, want = jax_run

    async def body():
        e = await _engine(tree, stand_in=False)
        assert e.model.graphs is None
        mgr, ids = e.model.hbm_block_mgrs[0], e.scheduler.id_managers[0]
        free0, ids0 = mgr.num_free_blocks, len(ids.available_ids)
        ran = _ran_buckets(e.model)
        await e.warmup()
        assert (mgr.num_free_blocks, len(ids.available_ids)) == (free0, ids0)
        assert set(ran) == set(warmup_buckets(e.engine_config))
        with pytest.raises(RuntimeError, match="eagerly"):
            await e.warmup(ran[:1])
        return await serve(e, RawRequest)
    assert asyncio.run(body()) == want


WARM_CONFIGS = {
    "default": {},
    "multi_step": dict(multi_step_decode=4),
    "spec": dict(enable_spec_decode=True, spec_k=3, spec_max_rows=4),
    "spec_multi_step": dict(enable_spec_decode=True, spec_k=3,
                            spec_max_rows=4, multi_step_decode=4),
}


@pytest.mark.parametrize("case", list(WARM_CONFIGS))
def test_warmup_buckets_are_the_steps_buckets(case):
    """``warmup_buckets`` (what the memory profile budgets graphs for) gives
    the buckets of the warm-up's steps at each temperature, in order: both
    temperatures of every shape, windows of ``multi_step_decode`` steps,
    and verify steps greedy only. Each step's requests have their own ids
    and the requests made are the ones handed back for release."""
    ec = EngineConfig(**dict(WEC, **WARM_CONFIGS[case]))
    keys = warmup_buckets(ec)
    assert len(keys) == len(set(keys))
    for temp in engine_mod.WARMUP_TEMPERATURES:
        made = []
        steps = list(engine_mod.warmup_steps(ec, temp,
                                             itertools.count().__next__, made))
        assert len({r.seq_id for r in made}) == len(made)
        assert all(r.temperature == temp for r in made)
        for rows, multi_step, done in steps:
            assert {id(s.request) for s in rows} <= {id(r) for r in made}
            assert {id(r) for r in done} <= {id(r) for r in made}
        ran = [select_buckets([rows], ec, multi_step=ms) for rows, ms, _ in steps]
        assert all(k.sampling == (temp > 0) for k in ran)
        assert set(ran) <= set(keys)
    assert {dataclasses.replace(k, sampling=0) for k in keys if k.sampling} \
        == {k for k in keys if not k.sampling and not k.spec}
    windows = {k.steps for k in keys if k.steps > 1}
    assert windows == ({ec.multi_step_decode} if ec.multi_step_decode > 1
                       else set())
    verify = [k for k in keys if k.spec]
    assert bool(verify) == ec.enable_spec_decode
    assert all(not k.sampling for k in verify)


def test_exec_memory_follows_the_most_steps_alive(jax_run, sms):
    """The bookkeeping of the graphs' executables (``graphs.ExecMemory``),
    whose device memory CUDA keeps once given: each graph holds a
    unit a layer of a step while it lives (a window of S steps S a layer),
    dropping the table releases them and leaves the peak, and what is still
    to take counts only the units beyond the peak."""
    tree, _ = jax_run
    mem = graphs.exec_memory("cpu")

    async def body():
        e = await _engine(tree, dict(multi_step_decode=4))
        e.model.graphs = graphs.StepGraphs("cpu", capture=rerun_capture,
                                           layers=MC["num_layers"])
        # Graph tables that earlier tests left as garbage release their
        # units when collected: collect them now, not during the warm-up.
        gc.collect()
        live0 = mem.live
        await e.warmup()
        table = e.model.graphs.table
        steps = MC["num_layers"] * sum(k.bucket.steps for k in table)
        assert any(k.bucket.steps == 4 for k in table)
        assert mem.live - live0 == steps and mem.peak >= mem.live
        peak = mem.peak
        e.model.graphs.clear()
        assert mem.live == live0 and mem.peak == peak
    asyncio.run(body())
    fresh = graphs.ExecMemory()
    fresh.per_unit = 1000.0
    fresh.hold(10)
    fresh.release(10)
    assert (fresh.live, fresh.peak) == (0, 10)
    assert fresh.to_take(4) == 0 and fresh.to_take(12) == 2000
    fresh.hold(3)
    assert fresh.to_take(8) == 1000
