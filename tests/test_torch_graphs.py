"""One CUDA graph per step bucket (``worker/graphs.py``), on the CPU.

A CUDA graph runs only on the card, so these tests hold what a graph relies
on, and the graph runner itself through a CPU stand-in for the capture:

- **Capturability.** The step function (``models/llama.py:make_step_fn``:
  ``unpack_step_batch``, then ``forward_shard`` or ``decode_multi_step``)
  runs under a ``TorchDispatchMode`` that fails on any read of a tensor's
  value on the host or any shape that depends on data, for every kind of
  bucket: prefill, decode, mixed, verify spans (with bf16 scores), multi-step
  windows (fused and deferred), sampling with logprobs, LoRA, fp8 KV, a
  window, INT8, INT4 and the plain attention path. The kernel wrappers are
  replaced by stand-ins of the right shapes: their plain versions read
  their inputs on the host by design, and on the card they launch kernels.
- **The graph key.** Rows with the same attention plans share a key and
  rows with other plans do not; either environment switch flipped gives
  another key; a key's graph plans over the most rows that keep its plans,
  which are the plans the wrappers choose; the counters' bound covers every
  launch.
- **The static-buffer runner.** With a stand-in capture that runs the step
  on the static buffers at each replay, steps of different contents give
  the eager step's tokens, step N's ``PendingTokens`` keep step N's tokens
  after step N+1, a replay whose batch is not copied in fails that, and the
  engine's tokens equal the JAX engine's.
- **``Engine.warmup(bucket_keys)``** captures exactly the keys given, and
  serving them afterwards captures nothing new.
- **The memory profile's buckets** (``LlamaModel.profile_keys``): the
  sampled, verify and window buckets that size the graph pool are the ones
  ``select_buckets`` makes, and each runs eagerly on an empty batch and
  captures, as ``profile_num_blocks`` runs them on the card.
- **``build.device_counters``** raises instead of growing while a graph
  holds it.

Inputs come from numpy generators with fixed seeds.
"""

import asyncio
import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models.llama import StepSwitches, make_step_fn
from swiftllm_tpu_torch.ops import build, int4_matmul
from swiftllm_tpu_torch.ops import layer_ops as lo
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker import graphs
from swiftllm_tpu_torch.worker.batch_builder import (BucketKey,
                                                     build_step_batch,
                                                     pack_step_batch,
                                                     packed_len)
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_engine import EC, MC, jax_run, serve  # noqa: F401

aten = torch.ops.aten

# --- capturability ------------------------------------------------------------


class NoHostReads(TorchDispatchMode):
    """Fails on every operation a CUDA graph cannot hold: a value read on
    the host (``_local_scalar_dense``: ``item``, ``bool``, ``int``) and a
    shape that depends on data (``nonzero``, ``masked_select``, boolean
    indexing, ``repeat_interleave`` by a tensor without its output size)."""

    BANNED = {aten._local_scalar_dense, aten.nonzero, aten.nonzero_static,
              aten.masked_select, aten.unique_consecutive, aten._unique2,
              aten.unique_dim}
    INDEXING = {aten.index, aten.index_put, aten.index_put_,
                aten._index_put_impl_}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in self.BANNED:
            raise AssertionError(f"host read or data-dependent shape: {func}")
        if (packet is aten.repeat_interleave
                and func._overloadname in ("Tensor", "self_Tensor")
                and kwargs.get("output_size") is None):
            raise AssertionError(f"repeat_interleave by a tensor: {func}")
        if packet in self.INDEXING:
            idx = args[1] if len(args) > 1 else kwargs.get("indices")
            if any(t is not None and t.dtype == torch.bool for t in idx):
                raise AssertionError(f"boolean indexing: {func}")
        return func(*args, **kwargs)


def _no_host(*a, **kw):
    raise AssertionError("a tensor read on the host inside the step")


class StandIns:
    """Shape-true stand-ins for the kernel wrappers (no host reads), and
    how often each ran. The rope wrappers' stand-ins run their plain
    versions (no host reads) and count as "store" each call that writes the
    cache (the span write folded into them), which on the CPU would run
    ``store_kv_plain``, a boolean-mask scatter."""

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(
            ("decode", "pend", "store", "prefill", "int4"), 0)
        monkeypatch.setattr(pa, "paged_decode_attention", self.decode)
        monkeypatch.setattr(pa, "paged_decode_attention_pend", self.pend)
        monkeypatch.setattr(lo, "rope_qkv", self.rope(lo.rope_qkv_plain))
        monkeypatch.setattr(lo, "rope_qkv_fp8", self.rope(lo.rope_qkv_fp8_plain))
        monkeypatch.setattr(pa, "paged_prefill_attention", self.prefill)
        monkeypatch.setattr(int4_matmul, "int4_proj_stacked", self.int4)

    def decode(self, q, cache, kv_new, page_table, q_lens, seq_lens, kv_slots,
               layer, **kw):
        assert kv_new.shape == (q.shape[0], cache.shape[2])
        assert kv_slots.shape[0] >= page_table.shape[0]
        self.calls["decode"] += 1
        return q * 0.5

    def pend(self, q, cache, kv_new, kv_pend, page_table, q_lens, seq_lens,
             layer, *, npend, **kw):
        assert kv_pend.shape[1:] == (kv_pend.shape[1], page_table.shape[0],
                                     cache.shape[2]) and 1 <= npend
        self.calls["pend"] += 1
        return q * 0.5

    def rope(self, plain):
        def fn(q, k, v, tables, bias=None, cache=None, slots=None, layer=0):
            q_rot, kv_new = plain(q, k, v, tables, bias)
            if slots is not None:
                assert kv_new.shape == (slots.shape[0], cache.shape[2])
                assert 0 <= layer < cache.shape[0]
                self.calls["store"] += 1
            return q_rot, kv_new
        return fn

    def prefill(self, q, cache, page_table, q_starts, q_lens, seq_lens, layer,
                **kw):
        assert q_starts.shape == q_lens.shape == (page_table.shape[0],)
        self.calls["prefill"] += 1
        return q * 0.25

    def int4(self, x, q4, s, layer, **kw):
        assert x.shape[1] == 2 * q4.shape[2]
        self.calls["int4"] += 1
        return x.new_zeros(x.shape[0], q4.shape[1])


SPEC_K = 3
# case -> (engine config, model config, rows, multi_step, switches, wrappers
# that must run). Rows: "p<n>" a fresh prompt of n tokens, "d<n>" a decode
# row over n tokens of history (the first of them fed from the feedback
# buffer), "v<n>" a verify span over n tokens of history.
CASES = {
    "prefill": ({}, {}, ["p5", "p20", "p9"], 1, (0, 0),
                {"decode", "store", "prefill"}),
    "decode": ({}, {}, ["d7", "d30", "d18"], 1, (0, 0), {"decode"}),
    "mixed": ({}, {}, ["d7", "d30", "p20"], 1, (0, 0),
              {"decode", "store", "prefill"}),
    "verify": (dict(enable_spec_decode=True, spec_k=SPEC_K), {},
               ["d7", "v30", "v12"], 1, (0, 1), {"decode", "store", "prefill"}),
    "multi_step": ({}, {}, ["d7", "d30", "d18"], 4, (0, 0), {"decode"}),
    "multi_step_deferred": ({}, {}, ["d7", "d30", "d18"], 4, (1, 0),
                            {"pend"}),
    "sampled_logprobs": (dict(enable_logprobs=True), {}, ["d7", "d30", "p20"],
                         1, (0, 0), {"decode", "store", "prefill"}),
    "multi_step_sampled": (dict(enable_logprobs=True), {},
                           ["d7", "d30", "d18"], 4, (0, 0), {"decode"}),
    "lora": (dict(lora_paths="dummy:a,b"), {}, ["d7", "d30", "p20"], 1,
             (0, 0), {"decode", "store", "prefill"}),
    "fp8_kv": (dict(kv_quant="fp8", block_size=32), {}, ["d7", "d30", "p20"], 1, (0, 0),
               {"decode", "store", "prefill"}),
    "window": ({}, dict(sliding_window=8), ["d7", "d30", "p20"], 1, (0, 0),
               {"decode", "store", "prefill"}),
    "int8": (dict(quant="int8"), {}, ["d7", "d30", "p20"], 1, (0, 0),
             {"decode", "store", "prefill"}),
    "int4": (dict(quant="int4"), {}, ["d7", "d30", "p20"], 1, (0, 0),
             {"decode", "store", "prefill", "int4"}),
    "plain": (dict(use_pallas=False), {}, ["d7", "d30", "p20"], 1, (0, 0),
              set()),
}


def _rows(kinds, rng, vocab, ec):
    """ScheduledSeqs of the case's rows; with logprobs on, rows 1 and 2
    sample (seeded), else every row is greedy."""
    out = []
    for i, kind in enumerate(kinds):
        n = int(kind[1:])
        kw = (dict(temperature=0.8, top_k=5, seed=11 + i)
              if i and ec.enable_logprobs else {})
        r = Request(RawRequest("", 16, **kw))
        r.set_prompt_token_ids(rng.integers(1, vocab, n).tolist())
        r.seq_id = i
        r.lora_slot = i % 3 if ec.lora_paths else 0
        if kind[0] == "p":
            out.append(ScheduledSeq(r, n))
            continue
        r.num_cached_tokens = n
        r.output_token_ids.append(None if i == 0 else int(rng.integers(1, vocab)))
        if kind[0] == "d":
            out.append(ScheduledSeq(r, 1))
        else:
            drafts = tuple(int(t) for t in rng.integers(1, vocab, SPEC_K))
            out.append(ScheduledSeq(r, 1 + SPEC_K, drafts=drafts))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_step_reads_nothing_on_the_host(case, monkeypatch):
    """Every bucket kind's step runs under NoHostReads (and with
    ``tolist``/``numpy``/``item`` refused), through the kernel path's
    stand-ins, and runs the wrappers its kind needs."""
    ec_kw, mc_kw, kinds, steps, switches, wanted = CASES[case]
    ec = EngineConfig(**{**EC, "use_pallas": True, **ec_kw})
    mc = LlamaModelConfig(**dict(MC, **mc_kw))
    m = LlamaModel(ec, mc, device="cpu")
    assert m.graphs is None               # the CPU runs eagerly, by rule
    m.load_weights()
    m.init_kvcache_and_swap()
    sched = _rows(kinds, np.random.default_rng(3), mc.vocab_size, ec)
    batch_np, key, _ = build_step_batch([sched], m.hbm_block_mgrs, ec,
                                        multi_step=steps)
    flat = torch.from_numpy(pack_step_batch(batch_np, 1))
    live = int(np.flatnonzero(batch_np.q_lens > 0)[-1]) + 1
    step = make_step_fn(
        mc, page_size=ec.block_size, q_bucket=key.q_len,
        use_kernels=ec.use_pallas, T=key.tokens, B=key.rows, Pg=key.pages,
        use_sampler=bool(key.sampling), return_logprobs=ec.enable_logprobs,
        sample_span=key.spec, multi_step=key.steps, live_rows=live,
        switches=StepSwitches(*map(bool, switches)))
    stand = StandIns(monkeypatch)
    for name in ("tolist", "numpy", "item"):
        monkeypatch.setattr(torch.Tensor, name, _no_host)
    with NoHostReads():
        tokens, logits, lp = step(m.params, m.kv_cache, m.token_feedback, flat)
    monkeypatch.undo()
    span = key.spec or key.steps
    assert tokens.shape == (key.rows * span,) and logits is None
    assert (lp is not None) == ec.enable_logprobs
    assert {k for k, n in stand.calls.items() if n} == wanted, stand.calls
    assert bool(key.sampling) == ec.enable_logprobs


def test_stand_ins_catch_a_host_read():
    """The mode refuses what it should: an item read, a boolean mask, and a
    repeat_interleave by a tensor."""
    x = torch.arange(6)
    for bad in (lambda: int(x.sum()), lambda: x[x > 2],
                lambda: x.repeat_interleave(x)):
        with pytest.raises(AssertionError), NoHostReads():
            bad()
    with NoHostReads():
        torch.where(x > 2, x, 0).repeat_interleave(3)


# --- the graph key -----------------------------------------------------------

W8B = dict(n_q=32, n_kv=8, hd=128, page_size=16, window=0, n_sms=132)
DECODE = BucketKey(tokens=128, rows=128, pages=2048, q_len=1)
MIXED = BucketKey(tokens=2048, rows=128, pages=2048, q_len=512)
VERIFY = BucketKey(tokens=128, rows=128, pages=128, q_len=8, spec=8)
OFF = StepSwitches(False, False)


def test_graph_key_follows_the_plans():
    """live_rows with the same plans give one key (and one row bound),
    other plans another key; the switches, the logits, the kernels-or-plain
    setting and logprobs are part of the key."""
    k70, r70 = graphs.graph_key(DECODE, False, 70, OFF, **W8B)
    k100, r100 = graphs.graph_key(DECODE, False, 100, OFF, **W8B)
    assert k70 == k100 and r70 == r100 == 128 and k70.plans.decode[0] == 1
    k3, r3 = graphs.graph_key(DECODE, False, 3, OFF, **W8B)
    k8, _ = graphs.graph_key(DECODE, False, 8, OFF, **W8B)
    assert k3 != k8 and k3.plans != k8.plans and k3.plans.decode[0] > 1
    assert r3 == 3          # 4 rows would split into fewer pieces
    for sw in (StepSwitches(True, False), StepSwitches(False, True)):
        assert graphs.graph_key(DECODE, False, 70, sw, **W8B)[0] != k70
    assert graphs.graph_key(DECODE, True, 70, OFF, **W8B)[0] != k70
    assert graphs.graph_key(DECODE, False, 70, OFF, use_kernels=False,
                            **W8B)[0] != k70
    assert graphs.graph_key(DECODE, False, 70, OFF, logprobs=True,
                            **W8B)[0] != k70
    assert k3.plans.prefill is None
    assert graphs.graph_key(MIXED, False, 4, OFF, **W8B)[0].plans.prefill


@pytest.mark.parametrize("key", [DECODE, MIXED, VERIFY],
                         ids=["decode", "mixed", "verify"])
def test_graph_plans_are_the_wrappers_plans(key):
    """For every live_rows of a bucket: step_plans gives the planners'
    answers for the rows a wrapper plans over; the graph's rows keep those
    plans and are the most that do; the counters' bound holds every launch's
    units."""
    group, n_kv = W8B["n_q"] // W8B["n_kv"], W8B["n_kv"]
    bound = pa.max_split_units(key.rows, key.tokens, n_q=W8B["n_q"],
                               n_kv=n_kv, hd=W8B["hd"])
    for live in range(1, key.rows + 1):
        R = pa.split_rows(key.rows, live)
        plans = pa.step_plans(key, live, **W8B)
        assert plans.decode == pa.decode_split_plan(
            R, n_kv, key.pages, 16, 132)
        if key.q_len > 1:
            assert plans.prefill == pa.prefill_split_plan(
                R, key.q_len, group, n_kv, key.pages, 16, 132, hd=128)
            assert pa.prefill_units(R, key.q_len, group, n_kv, 128) <= bound
        rows = pa.plan_rows(key, live, **W8B)
        assert live <= rows <= key.rows
        assert pa.step_plans(key, rows, **W8B) == plans
        if rows < key.rows:
            assert pa.step_plans(key, rows + 1, **W8B) != plans
        assert R * n_kv <= bound


def test_cpu_plans_never_split():
    """The CPU has no SMs: its plain versions run unsplit, and its plans are
    one split whatever the rows."""
    cpu = dict(W8B, n_sms=0)
    assert {pa.step_plans(MIXED, live, **cpu) for live in (1, 3, 128)} == {
        pa.step_plans(MIXED, 1, **cpu)}
    assert pa.step_plans(MIXED, 1, **cpu).decode[0] == 1
    assert pa.plan_rows(MIXED, 1, **cpu) == MIXED.rows


# --- the static-buffer runner --------------------------------------------------

class Rerun:
    """A CPU stand-in for a captured CUDA graph: each replay runs the step
    again on the static input and writes the static outputs."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        for dst, src in zip(self.outputs, self.fn()):
            if dst is not None:
                dst.copy_(src)


def rerun_capture(fn, state, pool, stream):
    """``graphs.cuda_capture``'s stand-in: runs the step once to make its
    outputs, leaving ``state`` as it found it, as a capture does."""
    saved = [t.clone() for t in state]
    outputs = fn()
    for t, s in zip(state, saved):
        t.copy_(s)
    return Rerun(fn, outputs), outputs


def _model(use_pallas, params=None, standin=False):
    m = LlamaModel(EngineConfig(**dict(EC, use_pallas=use_pallas)),
                   LlamaModelConfig(**MC), device="cpu")
    if params is None:
        m.load_weights()
    else:
        m.params = params
    m.init_kvcache_and_swap()
    if standin:
        m.graphs = graphs.StepGraphs("cpu", capture=rerun_capture)
    return m


def _drive(m):
    """Three prompts, then five decode steps over 3, 2, 3, 2, 3 of them,
    each fed its last token from the feedback buffer: dispatched one after
    another, every step's tokens resolved only after the last dispatch."""
    rng = np.random.default_rng(7)
    reqs = []
    for i, n in enumerate((5, 20, 9)):
        r = Request(RawRequest("", 32))
        r.set_prompt_token_ids(rng.integers(1, MC["vocab_size"], n).tolist())
        r.seq_id = i
        reqs.append(r)
    pending = []
    batches = [[ScheduledSeq(r, r.prompt_len) for r in reqs]]
    for k in range(5):
        batches.append([ScheduledSeq(r, 1) for r in reqs[:3 - k % 2]])
    for batch in batches:
        tokens, rows = m.forward_async(batch)
        pending.append((tokens, rows))
        for s in batch:
            s.request.num_cached_tokens += s.n_tokens
            s.request.output_token_ids.append(None)
    return [p.numpy()[[i for i, s in enumerate(rows) if s is not None]]
            for p, rows in pending]


@pytest.mark.parametrize("use_pallas", [True, False])
def test_replays_equal_eager_steps(use_pallas):
    """The stand-in runner replays the prefill key once and the decode key
    four times (2 and 3 live rows, other tokens each time): every step's
    tokens equal the eager model's, read after all six were dispatched."""
    eager = _model(use_pallas)
    m = _model(use_pallas, eager.params, standin=True)
    want, got = _drive(eager), _drive(m)
    assert len(m.graphs.table) == 2
    assert sorted(e.replays for e in m.graphs.table.values()) == [0, 4]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_replay_without_its_batch_fails(monkeypatch):
    """A planted fault: replays that skip the copy into the static input run
    the capture's batch again, and the tokens check rejects them."""
    eager = _model(True)
    m = _model(True, eager.params, standin=True)
    monkeypatch.setattr(graphs.CapturedStep, "load", lambda self, flat: None)
    want, got = _drive(eager), _drive(m)
    assert any(not np.array_equal(a, b) for a, b in zip(want, got))


async def _graph_engine(tree, use_pallas=True, keys=None):
    e = Engine(EngineConfig(**dict(EC, use_pallas=use_pallas)),
               LlamaModelConfig(**MC), device="cpu")
    await e.initialize(tokenizer_backend="inline")
    e.model.params = params_from_numpy(tree, "cpu")
    e.model.graphs = graphs.StepGraphs("cpu", capture=rerun_capture)
    if keys is not None:
        await e.warmup(keys)
    return e


@pytest.mark.parametrize("use_pallas", [True, False])
def test_graph_engine_tokens_match_jax(jax_run, use_pallas):
    """The port's engine serving every step from the stand-in runner: the
    same greedy tokens as the JAX engine on the same parameters."""
    tree, want = jax_run

    async def body():
        e = await _graph_engine(tree, use_pallas)
        got = await serve(e, RawRequest)
        return got, e.model.graphs.table
    got, table = asyncio.run(body())
    assert got == want
    assert sum(e.replays for e in table.values()) > 0


def test_warmup_with_keys_captures_exactly_them(jax_run):
    """``warmup(bucket_keys)`` leaves those keys in the table and runs no
    step; serving the same requests afterwards captures nothing new and
    gives the same tokens. An eager model refuses it."""
    tree, want = jax_run

    async def body():
        first = await _graph_engine(tree)
        assert await serve(first, RawRequest) == want
        keys = sorted({g.bucket for g in first.model.graphs.table},
                      key=lambda k: (k.tokens, k.q_len))
        e = await _graph_engine(tree, keys=keys)
        warmed = dict(e.model.graphs.table)
        assert sorted({g.bucket for g in warmed}, key=lambda k: (
            k.tokens, k.q_len)) == keys and len(warmed) == len(keys)
        assert all(v.replays == 0 for v in warmed.values())
        assert e.stats.num_steps == 0
        got = await serve(e, RawRequest)
        assert got == want
        assert e.model.graphs.table == warmed
        assert all(v.replays > 0 for v in warmed.values())
        eager = Engine(EngineConfig(**dict(EC, use_pallas=True)),
                       LlamaModelConfig(**MC), device="cpu")
        await eager.initialize(tokenizer_backend="inline")
        with pytest.raises(RuntimeError, match="eagerly"):
            await eager.warmup(keys)
    asyncio.run(body())


# --- the memory profile's buckets ----------------------------------------------

@pytest.mark.parametrize("defer", [False, True], ids=["fused", "deferred"])
def test_profile_keys_run_on_empty_batches(defer, monkeypatch):
    """``profile_keys`` gives the probe's prefill, the same bucket sampled, a
    sampled verify step at ``spec_max_rows`` and a sampled window of
    ``multi_step_decode`` steps, each as ``select_buckets`` makes it for
    such a batch; each runs eagerly on an empty batch of its shape (as the
    profile runs it), and each captures (the stand-in capture) over no
    live row."""
    monkeypatch.setenv("SWIFTLLM_DEFER_KV", "1" if defer else "0")
    ec = EngineConfig(**dict(EC, use_pallas=True, enable_spec_decode=True,
                             spec_k=SPEC_K, spec_max_rows=4,
                             multi_step_decode=4, enable_logprobs=True))
    m = LlamaModel(ec, LlamaModelConfig(**MC), device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    probe = BucketKey(tokens=128, rows=8, pages=16, q_len=32)
    keys = m.profile_keys(probe)
    assert keys[:2] == [probe, dataclasses.replace(probe, sampling=1)]
    assert [(k.q_len, k.sampling, k.spec, k.steps) for k in keys[2:]] == [
        (4, 1, 4, 1), (1, 1, 0, 4)]
    assert keys[2].tokens >= 4 * 4 and keys[3].tokens == ec.token_buckets[0]
    m.graphs = graphs.StepGraphs("cpu", capture=rerun_capture)
    graphs_, m.graphs = m.graphs, None
    for key in keys:
        tokens = m.execute_packed(np.zeros(packed_len(key), np.int32),
                                  key).numpy()
        assert tokens.shape == (key.rows * (key.spec or key.steps),)
        assert ((0 <= tokens) & (tokens < MC["vocab_size"])).all()
        assert np.isfinite(m.last_logprobs.numpy()).all()
    m.graphs = graphs_
    for key in keys:
        assert m.capture(key, live_rows=0) == 1
    assert {k.bucket for k in m.graphs.table} == set(keys)
    assert {k.switches.defer_kv for k in m.graphs.table} == {defer}


# --- the split counters --------------------------------------------------------

def test_device_counters_never_move_under_a_graph():
    """While a holder lives, a request for more counters (or for a new
    owner's) raises instead of reallocating; a request within the size gets
    the same buffer; once the holder is gone the buffer may grow."""

    class Holder:
        pass

    dev = torch.device("cpu")
    a = build.device_counters("graphs-test", dev, 4)
    holder = Holder()
    build.hold_counters(dev, holder)
    assert build.device_counters("graphs-test", dev, a.numel()) is a
    with pytest.raises(RuntimeError, match="held by captured CUDA graphs"):
        build.device_counters("graphs-test", dev, a.numel() + 1)
    with pytest.raises(RuntimeError):
        build.device_counters("graphs-test-new", dev, 1)
    del holder
    gc.collect()
    assert build.device_counters("graphs-test", dev, a.numel() + 1).numel() > a.numel()
