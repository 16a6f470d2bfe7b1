"""Speculative decoding in the port against the JAX package's, on the CPU.

Attention of a verify step: the caller's scatter of each span's KV, then the
tile kernel in its unfused mode over spans that start and end mid-page (q
bucket 8 = next_pow2(spec_k + 1)). The port's ``store_kv`` +
``paged_prefill_attention`` (their plain versions, on CPU tensors) against
the JAX scatter + ``ragged_paged_attention(kv_new=None, q_bucket=8)`` run as
Pallas in interpret mode, with an f32 cache, an fp8
cache, and a window. Tolerances: atol 2e-5 / rtol 1e-4 in f32 (only the
summation order differs), atol 1e-4 / rtol 1e-3 with fp8 (the fp8 file's:
scales folded in at different points); caches equal after the writes.

The bf16-score variant (``SWIFTLLM_TILE_BF16_SCORES=1``): the port's plain
version against the Pallas kernel in that mode, and against the port's f32
plain version, both within atol 3e-2 / rtol 3e-2 (the JAX test's bound: P in
bf16 carries about 1e-2 relative error, and the two sides round the exponent
argument against different running maxima). That bound also passes the f32
version, so a second case pins every row's maximum to key 0 and rounds the
reference's exp2 once (JAX's own bf16 exp2 goes through a bf16 ln 2): the
port is then within 2.5e-3 of the Pallas kernel, the bound is 5e-3, and the
port's f32 version, 2e-2 away, must fail it. It catches the rounding of the
scores and of the exponent argument; P's own rounding moves the output by
less (numerator and denominator share it). An fp8 or a windowed call is
byte-equal to its f32 call with the variable set.

The step: ``forward_shard(sample_span=8)`` through the port's ``LlamaModel``
against the JAX ``LlamaModel`` (``use_pallas=False``) on the same parameters,
cache, feedback buffer and packed batch: spec rows, a greedy decode row and a
sampled decode row (the JAX sampler's Gumbel noise injected, as in
tests/test_torch_sampling.py). Per-position greedy tokens and the feedback
buffer equal, logits within atol 1e-4 / rtol 1e-4 and logprobs within 1e-5
(f32 on both sides), the cache within 1e-5.

The engine: the ports of tests/test_spec_decode.py and
tests/test_spec_adaptive.py on the port's Engine (the kernels' plain
versions), and one case of the JAX and the port engines on the same tiny
weights with spec on, whose tokens and draft counters must be equal.

Inputs come from numpy generators with fixed seeds.
"""

import asyncio
import functools

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import jax.numpy as jnp
import torch

import swiftllm_tpu.server.spec as jax_spec
from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
from swiftllm_tpu.models import sampling as jax_sampling
from swiftllm_tpu.models.llama import StepBatch as JaxStepBatch
from swiftllm_tpu.models.llama import _attention_and_store as jax_attention_and_store
from swiftllm_tpu.ops.paged_attention import ragged_paged_attention
from swiftllm_tpu.server.engine import Engine as JaxEngine
from swiftllm_tpu.server.scheduler import ScheduledSeq as JaxScheduledSeq
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu.server.structs import Request as JaxRequest
from swiftllm_tpu.worker.model import LlamaModel as JaxLlamaModel
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models import llama
from swiftllm_tpu_torch.models import sampling
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.server import spec
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq, Scheduler
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_fp8_kv import fp8_case
from tests.test_torch_llama import scaled_params
from tests.test_torch_paged_attention import (BATCH_FIELDS, LAYER, _to_torch,
                                              assert_match, make_case, run_torch)
from tests.test_torch_sampling import jax_gumbel

SPEC_Q = 8   # next_pow2(spec_k + 1) at spec_k 4


# --- attention of a verify step ----------------------------------------------------

def run_jax_verify(case, monkeypatch, window=0):
    """The JAX verify step's attention: the caller's scatter of the spans'
    rows, the decode kernel on the decode-kind rows, the tile kernel in its
    unfused mode (``fused_tile`` off, no ``kv_new``) on the spans; Pallas in
    interpret mode."""
    monkeypatch.setenv("SWIFTLLM_PALLAS_INTERPRET", "1")
    batch = JaxStepBatch(token_ids=jnp.zeros(len(case["positions"]), jnp.int32),
                         sample_mask=jnp.zeros(len(case["q_lens"]), bool),
                         **{f: jnp.asarray(case[f]) for f in BATCH_FIELDS})
    fn = jax.jit(functools.partial(
        jax_attention_and_store, n_kv=case["n_kv"], page_size=case["page_size"],
        sm_scale=float(case["sm_scale"]), use_pallas=True,
        q_bucket=case["q_bucket"], window=window, fused_tile=False))
    out, cache = fn(jnp.asarray(case["q"]), jnp.asarray(case["kv_new"]),
                    jnp.asarray(case["cache"]), jnp.int32(LAYER), batch)
    return np.asarray(out), np.asarray(cache)


# name -> (rows (q_len, seq_len), decode rows first; make_case keywords).
# Spans of 2 to 8 tokens, most of them starting and ending mid-page (pages
# of 8), over histories of up to 512 keys.
VERIFY_CASES = {
    "spans_and_decode": ([(1, 33), (5, 40), (8, 24), (2, 9)], {}),
    "spans_2_to_8": ([(1, 129), (2, 11), (3, 46), (4, 302), (5, 77), (6, 6),
                      (7, 200), (8, 512)], dict(Pg=64)),
}
# kind -> (fp8 cache, window, atol, rtol)
VERIFY_KINDS = {"f32": (False, 0, 2e-5, 1e-4), "fp8": (True, 0, 1e-4, 1e-3),
                "window": (False, 24, 2e-5, 1e-4)}


def verify_case(name, stale=True):
    """A verify-step case whose rows' last pages hold, past seq_len, the
    rows of rejected drafts of an earlier step (``stale``: fresh values of
    the same distribution; else zeros)."""
    specs, kw = VERIFY_CASES[name]
    case = make_case(np.random.default_rng(20 + list(VERIFY_CASES).index(name)),
                     specs, q_bucket=SPEC_Q, **kw)
    assert any(ql > 1 and (sl - ql) % case["page_size"] for ql, sl in specs)
    rng = np.random.default_rng(99)
    cache = case["cache"].copy()
    ps = case["page_size"]
    for b, (_, sl) in enumerate(specs):
        for pos in range(sl, -(-sl // ps) * ps):       # the last page's tail
            slot = case["page_table"][b, pos // ps] * ps + pos % ps
            cache[LAYER, slot] = rng.normal(size=cache.shape[2]) if stale else 0.0
    return dict(case, cache=cache)


# The three kinds on the small case; the long one (every span length, to
# 512 keys) in f32 only: each case is one Pallas program in interpret mode.
@pytest.mark.parametrize("name,kind", [
    ("spans_and_decode", "f32"), ("spans_and_decode", "fp8"),
    ("spans_and_decode", "window"), ("spans_2_to_8", "f32")])
def test_verify_spans_match_pallas_unfused(name, kind, monkeypatch):
    fp8, window, atol, rtol = VERIFY_KINDS[kind]
    case = verify_case(name)
    if fp8:
        case = fp8_case(case)
    want = run_jax_verify(case, monkeypatch, window)
    assert_match(case, run_torch(case, True, window), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("window", [0, 24])
def test_verify_span_reads_no_stale_draft_rows(window):
    """Slots past a spec row's seq_len that still hold the rows of rejected
    drafts are never read: the output is the same, bit for bit, as with
    those slots cleared."""
    got = run_torch(verify_case("spans_2_to_8"), True, window)[0]
    want = run_torch(verify_case("spans_2_to_8", stale=False), True, window)[0]
    assert np.array_equal(got, want)


# --- the bf16-score variant ---------------------------------------------------------

# The case of tests/test_paged_attention.py:test_bf16_scores_close_to_f32.
BF16S_SPECS = [(16, 40), (9, 9), (32, 64)]


def bf16s_case(**kw):
    return make_case(np.random.default_rng(3), BF16S_SPECS, n_q=4, n_kv=2,
                     hd=64, **kw)


def port_prefill(case, window=0):
    t = {k: torch.from_numpy(case[k]) for k in
         ("q", "page_table", "q_starts", "q_lens", "seq_lens")}
    return pa.paged_prefill_attention(
        t["q"], _to_torch(case["cache"]), t["page_table"], t["q_starts"], t["q_lens"],
        t["seq_lens"], LAYER, n_kv=case["n_kv"], page_size=case["page_size"],
        sm_scale=case["sm_scale"], q_bucket=case["q_bucket"], window=window).numpy()


def assert_rows_close(case, got, want, atol, rtol):
    for b, ql in enumerate(case["q_lens"]):
        if ql:
            sl = slice(int(case["q_starts"][b]), int(case["q_starts"][b]) + int(ql))
            np.testing.assert_allclose(got[sl], want[sl], atol=atol, rtol=rtol,
                                       err_msg=f"row {b}")


def pin_row_max(case, gap=2.0):
    """The case with every query of kv head h along one direction (8 u_h
    plus N(0, 0.3) a dim) and key 0 of every row set to c u_h, c so that
    each query's raw score with key 0 tops its score with every key of the
    layer by ``gap``. The Pallas kernel's running maximum (over raw scores
    of whole chunks, masked keys included) and the plain version's row
    maximum are then both key 0's score: the two round the exponent argument
    against the same bf16(m)."""
    rng = np.random.default_rng(5)
    q, cache = case["q"].copy(), case["cache"].copy()
    n_kv, hd, ps = case["n_kv"], q.shape[2], case["page_size"]
    grp = q.shape[1] // n_kv
    for h in range(n_kv):
        u = rng.normal(size=hd)
        u /= np.linalg.norm(u)
        qh = 8 * u + 0.3 * rng.normal(size=(q.shape[0], grp, hd))
        q[:, h * grp:(h + 1) * grp] = qh
        qh = qh.reshape(-1, hd)
        top = (qh @ cache[LAYER, :, h * hd:(h + 1) * hd].T).max(1)
        c = ((top + gap) / (qh @ u)).max()
        for b, ql in enumerate(case["q_lens"]):
            if ql:
                cache[LAYER, case["page_table"][b, 0] * ps, h * hd:(h + 1) * hd] = c * u
    return dict(case, q=q.astype(np.float32), cache=cache.astype(np.float32))


def _exp2_rounded_once(real):
    """exp2 computed in f32 and rounded once to the argument's type. JAX
    lowers a bf16 exp2 as exp(bf16(x * bf16(ln 2))): ln 2 becomes 0.69140625
    and the product is rounded, up to 6.6% off a correctly rounded exp2."""
    return lambda x: real(x.astype(jnp.float32)).astype(x.dtype)


# kind -> (case, reference exp2 rounded once, atol = rtol, control).
# "jax_case": the JAX test's case and bound. "pinned": row maxima pinned and
# the reference's exp2 rounded once, so that both sides round at the same
# points against the same m; the port then stays within 2.5e-3 of the
# Pallas kernel, and its f32 version (2e-2 away) must fail the bound.
BF16S_PALLAS = {"jax_case": (bf16s_case, False, 3e-2, False),
                "pinned": (lambda: pin_row_max(bf16s_case()), True, 5e-3, True)}


@pytest.mark.parametrize("kind", list(BF16S_PALLAS))
def test_bf16_scores_match_pallas(kind, monkeypatch):
    make, exp2_once, tol, control = BF16S_PALLAS[kind]
    case = make()
    f32 = port_prefill(case)
    monkeypatch.setenv("SWIFTLLM_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("SWIFTLLM_TILE_BF16_SCORES", "1")
    if exp2_once:
        monkeypatch.setattr(jnp, "exp2", _exp2_rounded_once(jnp.exp2))
    batch = JaxStepBatch(token_ids=jnp.zeros(len(case["positions"]), jnp.int32),
                         sample_mask=jnp.zeros(len(case["q_lens"]), bool),
                         **{f: jnp.asarray(case[f]) for f in BATCH_FIELDS})
    want = np.asarray(ragged_paged_attention(
        jnp.asarray(case["q"]), jnp.asarray(case["cache"]), jnp.int32(LAYER),
        batch, n_kv=case["n_kv"], page_size=case["page_size"],
        sm_scale=float(case["sm_scale"]), q_bucket=case["q_bucket"],
        interpret=True))
    assert_rows_close(case, port_prefill(case), want, tol, tol)
    if control:
        with pytest.raises(AssertionError):
            assert_rows_close(case, f32, want, tol, tol)


def test_bf16_scores_close_to_f32(monkeypatch):
    case = bf16s_case()
    f32 = port_prefill(case)
    monkeypatch.setenv("SWIFTLLM_TILE_BF16_SCORES", "1")
    bf16s = port_prefill(case)
    assert_rows_close(case, bf16s, f32, 3e-2, 3e-2)
    assert not np.array_equal(bf16s, f32), "the variable changed nothing"


@pytest.mark.parametrize("kind", ["fp8", "window"])
def test_bf16_scores_gate_keeps_f32(kind, monkeypatch):
    """The JAX gate: an fp8 cache or a window keeps f32 scores."""
    case = bf16s_case()
    window = 8 if kind == "window" else 0
    if kind == "fp8":
        case = fp8_case(case)
    f32 = port_prefill(case, window)
    monkeypatch.setenv("SWIFTLLM_TILE_BF16_SCORES", "1")
    assert not pa.bf16_scores_on(_to_torch(case["cache"]), window)
    assert pa.bf16_scores_on(torch.from_numpy(bf16s_case()["cache"]), 0)
    assert np.array_equal(port_prefill(case, window).view(np.uint8),
                          f32.view(np.uint8))


# --- one verify step of forward_shard -------------------------------------------------

STEP_MC = dict(num_layers=3, num_q_heads=4, num_kv_heads=2, hidden_size=64,
               head_dim=16, ffn_inter_dim=128, vocab_size=128,
               max_position_embeddings=512, rms_norm_eps=1e-5)
STEP_EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=8,
               num_hbm_blocks=32, max_blocks_per_seq=8, max_batch_size=8,
               max_tokens_in_batch=64, prefill_chunk_size=16,
               max_seqs_in_block_table=8, preemption_mode="recompute",
               use_pallas=False, enable_spec_decode=True, spec_k=4,
               enable_logprobs=True)
# (prompt_len, outputs, drafts, temperature) of decode-stage requests: a
# greedy decode row, a sampled one whose last token is still on the device
# (read from the feedback buffer), and spec rows whose spans start mid-page.
STEP_ROWS = [(10, [5], (), 0.0), (13, [7, None], (), 0.8),
             (21, [3], (4, 5, 6, 7), 0.0), (6, [2, 8, 1], (11, 12), 0.0),
             (30, [9, 9], (1, 2, 3), 0.0)]


def step_sched(pkg):
    Req, Raw, Sched = ((JaxRequest, JaxRawRequest, JaxScheduledSeq) if pkg == "jax"
                       else (Request, RawRequest, ScheduledSeq))
    out = []
    for i, (plen, outputs, drafts, temp) in enumerate(STEP_ROWS):
        r = Req(Raw("", 16, temperature=temp, seed=40 + i))
        r.set_prompt_token_ids([(5 * i + j) % 120 + 1 for j in range(plen)])
        r.output_token_ids = list(outputs)
        r.num_cached_tokens = plen + len(outputs) - 1
        r.seq_id = i + 1
        out.append(Sched(r, 1 + len(drafts), drafts=drafts))
    return out


def step_preallocate(mgr):
    for i, (plen, outputs, _, _) in enumerate(STEP_ROWS):
        mgr.allocate_for_seq(i + 1, plen + len(outputs) - 1)


@pytest.fixture(scope="module")
def jax_verify_step():
    rng = np.random.default_rng(0)
    m = JaxLlamaModel(JaxEngineConfig(**STEP_EC), JaxModelConfig(**STEP_MC))
    m.load_weights()
    m.init_kvcache_and_swap()
    tree = scaled_params(m.params, rng)
    m.params = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                            m.params, tree)
    cache = rng.normal(size=m.kv_cache.shape).astype(np.float32)
    feedback = rng.integers(0, 128, size=m.token_feedback.shape).astype(np.int32)
    m.kv_cache = jax.device_put(cache, m.kv_cache.sharding)
    m.token_feedback = jax.device_put(feedback, m.token_feedback.sharding)
    step_preallocate(m.hbm_block_mgrs[0])
    saved = jax_sampling.EXACT_TOPK
    jax_sampling.EXACT_TOPK = True
    try:
        tokens, rows, logits = m.forward(step_sched("jax"), return_logits=True)
    finally:
        jax_sampling.EXACT_TOPK = saved
    return dict(tree=tree, cache=cache, feedback=feedback, tokens=tokens,
                logits=logits, logprobs=np.asarray(m.last_logprobs),
                spans=[0 if r is None else r.n_tokens for r in rows],
                key=m.last_key, cache_after=np.asarray(m.kv_cache),
                feedback_after=np.asarray(m.token_feedback))


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_verify_step_matches_jax(jax_verify_step, use_kernels, monkeypatch):
    ref = jax_verify_step
    real = llama.sample_tokens

    def with_jax_noise(logits, *, seeds, **kw):
        u = (seeds.long() & 0xFFFFFFFF).numpy().astype(np.uint32)
        C = min(sampling.MAX_CAND, logits.shape[-1])
        return real(logits, seeds=seeds, gumbel=torch.from_numpy(jax_gumbel(u, C)),
                    **kw)

    monkeypatch.setattr(llama, "sample_tokens", with_jax_noise)
    m = LlamaModel(EngineConfig(**dict(STEP_EC, use_pallas=use_kernels)),
                   LlamaModelConfig(**STEP_MC), device="cpu")
    m.params = params_from_numpy(ref["tree"], "cpu")
    m.init_kvcache_and_swap()
    m.kv_cache.copy_(torch.from_numpy(ref["cache"]))
    m.token_feedback.copy_(torch.from_numpy(ref["feedback"]))
    step_preallocate(m.hbm_block_mgrs[0])
    tokens, rows, logits = m.forward(step_sched("port"), return_logits=True)
    logprobs = m.last_logprobs.numpy()

    assert m.last_key.spec == ref["key"].spec == SPEC_Q
    assert m.last_key.sampling == 1 and m.last_key.q_len == SPEC_Q
    spans = [0 if r is None else r.n_tokens for r in rows]
    assert spans == ref["spans"]
    # Valid positions: the first n_tokens of each live row's span, row-major.
    valid = np.zeros((len(spans), SPEC_Q), bool)
    for i, n in enumerate(spans):
        valid[i, :n] = True
    valid = valid.reshape(-1)
    assert tokens.shape == logits.shape[:1] == logprobs.shape == valid.shape
    np.testing.assert_array_equal(tokens[valid], ref["tokens"][valid])
    np.testing.assert_allclose(logits[valid], ref["logits"][valid],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logprobs[valid], ref["logprobs"][valid],
                               atol=1e-5, rtol=0)
    # Every greedy position is its argmax; the sampled row is at position 0
    # of its span.
    sampled = [i * SPEC_Q for i, r in enumerate(rows)
               if r is not None and r.request.temperature > 0]
    greedy = valid.copy()
    greedy[sampled] = False
    assert len(sampled) == 1 and greedy.sum() == valid.sum() - 1
    np.testing.assert_array_equal(tokens[greedy], logits[greedy].argmax(-1))
    np.testing.assert_array_equal(m.token_feedback.numpy()[:-1],
                                  ref["feedback_after"][:-1])
    ps = STEP_EC["block_size"]
    np.testing.assert_allclose(m.kv_cache.numpy()[:, :-ps],
                               ref["cache_after"][:, :-ps], atol=1e-5, rtol=0)


# --- the engine: tests/test_spec_decode.py and tests/test_spec_adaptive.py ----------

@pytest.mark.parametrize("toks,k,ngram_max,want", [
    ([1, 2, 3, 9, 1, 2, 3], 2, 3, [9, 1]),                  # basic repeat
    ([1, 2, 3, 9, 8, 2, 3, 4, 1, 2, 3], 1, 3, [9]),         # longest n-gram wins
    ([5, 6, 1, 5, 6, 2, 5, 6], 1, 2, [2]),                  # most recent occurrence
    ([1, 2, 3, 4, 5], 4, 3, []),                            # no match
    ([7], 4, 3, []),                                        # short context
    ([], 4, 3, []),
], ids=["repeat", "longest", "recent", "no_match", "short", "empty"])
def test_propose(toks, k, ngram_max, want):
    assert spec.propose(np.array(toks, np.int32), k=k, ngram_max=ngram_max,
                        ngram_min=2) == want


def test_spec_state_growth_and_sync():
    st = spec.SpecState(capacity=4)
    st.extend([1, 2, 3])
    st.extend([4, 5, 6, 7, 8])        # forces regrow
    assert st.view().tolist() == [1, 2, 3, 4, 5, 6, 7, 8]

    class R:
        prompt_len = 3
        prompt_token_ids = [9, 8, 7]
        output_token_ids = [1, None]
    r = R()
    assert spec.sync_state(r) is None  # unresolved value: no drafting
    r.output_token_ids = [1, 2]
    st = spec.sync_state(r)
    assert st is not None and st.view().tolist() == [9, 8, 7, 1, 2]


ENG_MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
              head_dim=16, ffn_inter_dim=128, vocab_size=256,
              max_position_embeddings=2048, rms_norm_eps=1e-5)
ENG_EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=16,
              num_hbm_blocks=64, num_cpu_blocks=0, max_blocks_per_seq=16,
              max_batch_size=8, max_tokens_in_batch=128, prefill_chunk_size=32,
              max_seqs_in_block_table=32, preemption_mode="recompute",
              use_pallas=True)
SPEC_EC = dict(enable_spec_decode=True, spec_k=3, spec_ngram_max=3,
               spec_ngram_min=2)
REP_PROMPTS = [
    [5, 6, 7, 5, 6, 7, 5, 6],          # periodic
    [1, 2, 3, 4, 9, 9, 1, 2, 3],
    [42] * 12,
    [3, 1, 4, 1, 5, 9, 2, 6],          # aperiodic
]


async def _serve(engine, raws, timeout=120):
    loops = asyncio.create_task(engine.start_all_event_loops())
    try:
        outs = await asyncio.wait_for(asyncio.gather(*[
            engine.add_request_and_wait(r) for r in raws]), timeout)
    finally:
        loops.cancel()
    return [list(t) for _, t in outs]


def generate(n_out=12, spec_on=False, params=None, prompts=REP_PROMPTS, keys=None,
             **ec_kw):
    """``prompts`` through the port's Engine on the CPU: (tokens, stats);
    each step's bucket key is appended to ``keys`` if given."""
    async def body():
        ec = dict(ENG_EC, **(SPEC_EC if spec_on else {}))
        ec.update(ec_kw)
        e = Engine(EngineConfig(**ec), LlamaModelConfig(**ENG_MC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        if params is not None:
            e.model.params = params
        if keys is not None:
            real = e.model.execute_packed

            def spy(flat, key, *a):
                keys.append(key)
                return real(flat, key, *a)
            e.model.execute_packed = spy
        toks = await _serve(e, [RawRequest("", n_out, prompt_token_ids=list(p))
                                for p in prompts])
        return toks, e.stats.snapshot()
    return asyncio.run(body())


@pytest.fixture(scope="module")
def plain():
    """Plain greedy runs of 12 and 24 tokens, shared; "stats" of the first."""
    toks12, stats = generate(12)
    return {12: toks12, 24: generate(24)[0], "stats": stats}


def oracle(plain_outputs, offset=0, prompts=REP_PROMPTS, corrupt=None):
    """A proposer that continues a context it recognises with the true
    (plain-greedy) continuation shifted by ``offset`` (0: drafts always
    accept; else they never can). ``corrupt`` j: draft j is shifted by one,
    so exactly the drafts before it accept."""
    seqs = [list(p) + list(o) for p, o in zip(prompts, plain_outputs)]

    def fake(tokens, k, ngram_max=3, ngram_min=2):
        ctx = tokens.tolist()
        for s in seqs:
            if len(ctx) < len(s) and s[:len(ctx)] == ctx:
                cont = [(t + offset) % 256 for t in s[len(ctx):len(ctx) + k]]
                if corrupt is not None and corrupt < len(cont):
                    cont[corrupt] = (cont[corrupt] + 1) % 256
                return cont
        return []
    return fake


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_spec_matches_plain_greedy(plain, use_pallas):
    toks, stats = generate(12, spec_on=True, use_pallas=use_pallas)
    assert toks == plain[12]
    assert all(len(t) == 12 for t in toks)
    assert 0 <= stats["num_spec_accepted"] <= stats["num_spec_drafted"]


def test_spec_rows_without_drafts_take_one_token():
    """Requests of period 6 whose prompts finish prefilling in different
    steps: verify steps then carry rows without drafts beside rows with
    them. Such a row takes its span's first token alone; the tokens equal
    plain greedy (the JAX engine reads the whole span there and emits its
    pad positions' zeros: ROADMAP.md, queue 3)."""
    prompts = [[(7 * i + j % 6) % 250 + 1 for j in range(n)]
               for i, n in enumerate((5, 20, 40, 70, 100))]
    kw = dict(n_out=16, prompts=prompts, num_hbm_blocks=128)
    keys = []
    toks, stats = generate(spec_on=True, keys=keys, **kw)
    assert toks == generate(**kw)[0]
    assert stats["num_spec_drafted"] > 0 and any(k.spec for k in keys)


@pytest.mark.parametrize("offset", [0, 1], ids=["accept", "reject"])
def test_spec_forced_accept_and_reject(plain, offset, monkeypatch):
    plain_stats = plain["stats"]
    monkeypatch.setattr(spec, "propose", oracle(plain[12], offset))
    toks, stats = generate(12, spec_on=True)
    assert toks == plain[12]                     # lossless either way
    assert stats["num_spec_drafted"] > 0         # the machinery really ran
    if offset == 0:
        assert stats["num_spec_accepted"] == stats["num_spec_drafted"]
        assert stats["num_steps"] < plain_stats["num_steps"]
    else:
        assert stats["num_spec_accepted"] == 0


def test_spec_respects_output_len(plain, monkeypatch):
    monkeypatch.setattr(spec, "propose", oracle(plain[12]))
    toks, stats = generate(5, spec_on=True)
    assert stats["num_spec_drafted"] > 0
    assert toks == [t[:5] for t in plain[12]]


def test_spec_with_sampled_rows_mixed(plain, monkeypatch):
    """A temperature > 0 row never drafts but shares verify steps with spec
    rows; the greedy row stays lossless."""
    monkeypatch.setattr(spec, "propose", oracle(plain[12]))

    async def body():
        e = Engine(EngineConfig(**dict(ENG_EC, **SPEC_EC)),
                   LlamaModelConfig(**ENG_MC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        keys = []
        real = e.model.execute_packed

        def spy(flat, key, *a):
            keys.append(key)
            return real(flat, key, *a)
        e.model.execute_packed = spy
        toks = await _serve(e, [
            RawRequest("", 10, prompt_token_ids=REP_PROMPTS[0]),
            RawRequest("", 10, prompt_token_ids=[8, 1, 8, 1, 8],
                       temperature=0.8, seed=7)])
        return toks, keys, e.stats.snapshot()

    (greedy, sampled), keys, stats = asyncio.run(body())
    assert greedy == plain[12][0][:10] and len(sampled) == 10
    assert stats["num_spec_accepted"] == stats["num_spec_drafted"] > 0
    assert any(k.spec and k.sampling for k in keys), "no shared verify step"


def test_spec_with_prefix_caching(plain, monkeypatch):
    monkeypatch.setattr(spec, "propose", oracle(plain[12]))
    toks, stats = generate(12, spec_on=True, enable_prefix_caching=True)
    assert toks == plain[12] and stats["num_spec_drafted"] > 0
    assert generate(12, enable_prefix_caching=True)[0] == plain[12]


def test_spec_under_page_pressure(monkeypatch):
    """A pool of 10 pages: drafting must never over-allocate, and the
    outputs stay lossless."""
    kw = dict(num_hbm_blocks=10, max_batch_size=4)
    tight_plain, _ = generate(12, **kw)
    monkeypatch.setattr(spec, "propose", oracle(tight_plain))
    toks, stats = generate(12, spec_on=True, **kw)
    assert toks == tight_plain and stats["num_spec_drafted"] > 0


def test_spec_warmup_runs_spec_buckets():
    """Warm-up with spec on runs verify steps (q bucket next_pow2(spec_k + 1)
    = 4 at spec_k 3) for 1 and 2 spec rows, gives every page back, and
    serving works after it."""
    async def body():
        e = Engine(EngineConfig(**dict(ENG_EC, **SPEC_EC, spec_max_rows=2)),
                   LlamaModelConfig(**ENG_MC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        keys = []
        real = e.model.execute_packed

        def spy(flat, key, *a):
            keys.append(key)
            return real(flat, key, *a)
        e.model.execute_packed = spy
        await e.warmup()
        free = e.model.hbm_block_mgrs[0].num_free_blocks
        toks = await _serve(e, [RawRequest("", 6, prompt_token_ids=[5, 6, 7, 5, 6, 7])])
        return keys, toks, free

    keys, toks, free = asyncio.run(body())
    spec_keys = [k for k in keys if k.spec]
    assert spec_keys and {k.q_len for k in spec_keys} == {4}
    assert len({k.tokens for k in spec_keys}) == 2        # 1 and 2 spec rows
    assert free == ENG_EC["num_hbm_blocks"] and len(toks[0]) == 6


# The acceptance-adaptive policy (tests/test_spec_adaptive.py).

def _sched(**kw):
    mc = LlamaModelConfig(num_layers=1, num_q_heads=2, num_kv_heads=1,
                          hidden_size=32, head_dim=16, ffn_inter_dim=64,
                          vocab_size=64, max_position_embeddings=512,
                          rms_norm_eps=1e-5)
    ec = EngineConfig(model_path="", use_dummy=True, block_size=16,
                      num_hbm_blocks=32, num_cpu_blocks=0, max_batch_size=4,
                      max_tokens_in_batch=256, enable_spec_decode=True,
                      spec_k=4, **kw)
    return Scheduler(mc, ec, num_hbm_blocks=32)


def _req():
    r = Request(RawRequest("", 64))
    r.set_prompt_token_ids([1] * 8)
    return r


@pytest.mark.parametrize("drafted,accepted,cap", [
    (0, 0, 4), (7, 0, 4),              # optimistic until 2 * spec_k drafted
    (20, 20, 4), (20, 10, 2), (20, 9, 2)],   # scaled to the acceptance
    ids=["fresh", "short_history", "all", "half", "45_percent"])
def test_adaptive_budget(drafted, accepted, cap):
    r = _req()
    r.spec_drafted, r.spec_accepted = drafted, accepted
    assert _sched()._adaptive_spec_cap(r) == cap


def test_low_acceptance_suppresses_with_probes():
    s = _sched(spec_probe_interval=8)
    r = _req()
    r.spec_drafted, r.spec_accepted = 20, 2    # 10%, below the 0.4 floor
    caps = [s._adaptive_spec_cap(r) for _ in range(16)]
    assert caps.count(0) == 14 and caps.count(2) == 2
    assert r.spec_drafted < 20                 # each probe halved the history


def test_probe_recovery_after_regime_change():
    s = _sched(spec_probe_interval=4)
    r = _req()
    r.spec_drafted, r.spec_accepted = 32, 0
    for _ in range(64):
        cap = s._adaptive_spec_cap(r)
        if cap > 0:
            r.spec_drafted += cap
            r.spec_accepted += cap
        if r.spec_drafted and r.spec_accepted / r.spec_drafted >= 0.4:
            break
    assert s._adaptive_spec_cap(r) >= 1


def test_adaptive_engine_lossless_and_saves_wasted_drafts(plain, monkeypatch):
    monkeypatch.setattr(spec, "propose", oracle(plain[24], 0))
    accept, st_a = generate(24, spec_on=True)
    assert accept == plain[24]
    assert st_a["num_spec_accepted"] == st_a["num_spec_drafted"] > 0
    monkeypatch.setattr(spec, "propose", oracle(plain[24], 1))
    rej_static, st_s = generate(24, spec_on=True, spec_adaptive=False)
    rej_adapt, st_d = generate(24, spec_on=True, spec_probe_interval=8)
    assert rej_static == plain[24] and rej_adapt == plain[24]
    assert st_d["num_spec_drafted"] < st_s["num_spec_drafted"] // 2


# --- the JAX engine and the port's, spec on ----------------------------------------

def test_engine_spec_matches_jax_engine(monkeypatch):
    """The same tiny weights (the JAX dummy tree scaled to O(0.1), clear
    greedy margins) in both engines, spec on, drafts from an oracle that
    knows the plain continuation but gets every third draft wrong: equal
    tokens, equal drafted and accepted counts, some drafts rejected."""
    from tests.test_torch_engine import EC, MC, PROMPTS
    ec = dict(EC, enable_spec_decode=True, spec_k=4, spec_max_rows=8)
    jm = JaxLlamaModel(JaxEngineConfig(**EC), JaxModelConfig(**MC))
    jm.load_weights()
    tree = scaled_params(jm.params, np.random.default_rng(5))

    async def port_run(cfg):
        e = Engine(EngineConfig(**dict(cfg, use_pallas=True)),
                   LlamaModelConfig(**MC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        e.model.params = params_from_numpy(tree, "cpu")
        toks = await _serve(e, [RawRequest("", 12, prompt_token_ids=p)
                                for p in PROMPTS])
        return toks, e.stats.snapshot()

    base, _ = asyncio.run(port_run(EC))
    fake = oracle(base, prompts=PROMPTS, corrupt=2)
    monkeypatch.setattr(spec, "propose", fake)
    monkeypatch.setattr(jax_spec, "propose", fake)
    got, st_port = asyncio.run(port_run(ec))

    async def jax_run():
        e = JaxEngine(JaxEngineConfig(**ec), JaxModelConfig(**MC))
        await e.initialize(tokenizer_backend="inline")
        e.model.params = jax.tree.map(
            lambda old, new: jax.device_put(new, old.sharding), e.model.params, tree)
        toks = await _serve(e, [JaxRawRequest("", 12, prompt_token_ids=p)
                                for p in PROMPTS])
        return toks, e.stats.snapshot()

    want, st_jax = asyncio.run(jax_run())
    assert got == want == base
    for k in ("num_spec_drafted", "num_spec_accepted", "num_steps"):
        assert st_port[k] == st_jax[k], k
    assert 0 < st_port["num_spec_accepted"] < st_port["num_spec_drafted"]
