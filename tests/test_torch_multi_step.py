"""Multi-step decode in the port, on the CPU.

S decode steps from one dispatch (``models.llama.decode_multi_step``) must
give the tokens of S sequential single steps: greedy and seeded sampled,
across a page boundary, with the last token left unresolved between
dispatches, and in deferred-commit mode (the decode entry's ``pend`` variant,
whose plain PyTorch version runs here) as with the fused write. Greedy tokens
also equal the JAX package's multi-step tokens on the same parameters
(``params_from_numpy``), in f32; the deferred case runs the JAX side through
its Pallas kernel in interpret mode.

Below the model: ``advance_decode_batch`` field by field against the JAX
package's, and the ``pend`` plain version against the Pallas kernel in
interpret mode on the case of ``tests/test_paged_attention.py``
(``test_deferred_pending_matches_fused_stepwise``), within atol 2e-5 / rtol
1e-4 in float32 (only the summation order differs).

Above it: the engine scenarios of ``tests/test_multi_step_engine.py`` on the
port's Engine (greedy, seeded sampled, EOS inside a window, page pressure
falling back to single steps), with logprobs on.

Inputs come from numpy generators with fixed seeds.
"""

import asyncio

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import jax.numpy as jnp
import torch

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
from swiftllm_tpu.models import llama as jax_llama
from swiftllm_tpu.ops.paged_attention import (decode_group_geometry,
                                              ragged_paged_attention)
from swiftllm_tpu.server.scheduler import ScheduledSeq as JaxScheduledSeq
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu.server.structs import Request as JaxRequest
from swiftllm_tpu.worker.model import LlamaModel as JaxLlamaModel
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models import llama
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_llama import scaled_params

B_BUCKET = 4
PROMPTS = [[(i * 13 + j) % 127 + 1 for i in range(14 + 3 * j)] for j in range(3)]
# The widths of tests/test_multi_step.py: a small model for the gather path,
# and one the Pallas decode kernel accepts (n_q * hd = W = 128) for the
# deferred-commit cases.
WIDTHS = {
    "gather": dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
                   head_dim=16, ffn_inter_dim=128),
    "kernel": dict(num_layers=2, num_q_heads=2, num_kv_heads=1, hidden_size=128,
                   head_dim=64, ffn_inter_dim=256),
}
PKG = {"jax": (JaxLlamaModel, JaxEngineConfig, JaxModelConfig, JaxRequest,
               JaxRawRequest, JaxScheduledSeq),
       "port": (LlamaModel, EngineConfig, LlamaModelConfig, Request, RawRequest,
                ScheduledSeq)}


def configs(kind: str, block_size=16):
    mc = dict(WIDTHS[kind], vocab_size=128, max_position_embeddings=2048,
              rms_norm_eps=1e-5)
    ec = dict(model_path="", use_dummy=True, dtype="float32",
              block_size=block_size, num_hbm_blocks=64, num_cpu_blocks=0,
              max_blocks_per_seq=8, max_batch_size=B_BUCKET,
              max_tokens_in_batch=256, prefill_chunk_size=64,
              max_seqs_in_block_table=16, preemption_mode="recompute",
              use_pallas=kind == "kernel")
    return ec, mc


_TREES = {}


def tree_of(kind: str):
    """The JAX dummy parameter tree of these widths, scaled to O(0.1) weights
    (clear greedy margins), as numpy; both packages' models take it."""
    if kind not in _TREES:
        ec, mc = configs(kind)
        m = JaxLlamaModel(JaxEngineConfig(**dict(ec, use_pallas=False)),
                          JaxModelConfig(**mc))
        m.load_weights()
        _TREES[kind] = scaled_params(m.params, np.random.default_rng(2))
    return _TREES[kind]


def make_model(pkg: str, kind: str, **ec_kw):
    Model, EC, MC = PKG[pkg][:3]
    ec, mc = configs(kind)
    ec.update(ec_kw)
    if pkg == "jax":
        m = Model(EC(**ec), MC(**mc))
        m.load_weights()
        m.params = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                                m.params, tree_of(kind))
    else:
        m = Model(EC(**ec), MC(**mc), device="cpu")
        m.params = params_from_numpy(tree_of(kind), "cpu")
    m.init_kvcache_and_swap()
    return m


def prefill(pkg, model, **sampling):
    _, _, _, Req, Raw, Sched = PKG[pkg]
    reqs = []
    for i, p in enumerate(PROMPTS):
        r = Req(Raw("", 64, **sampling))
        r.set_prompt_token_ids(p)
        r.seq_id = i
        reqs.append(r)
    tokens, rows = model.forward([Sched(r, r.prompt_len) for r in reqs])
    for i, s in enumerate(rows):
        if s is not None and s.samples_token:
            s.request.output_token_ids.append(int(tokens[i]))
            s.request.num_cached_tokens += s.n_tokens
    return reqs


def decode(pkg, model, reqs, S, n_dispatch, hold_last=False, logprobs=None):
    """n_dispatch dispatches of S decode steps each (S = 1: single steps).
    With ``hold_last`` the last token's VALUE of every dispatch stays
    unresolved (None) until the end, as the engine's pipeline leaves it."""
    Sched = PKG[pkg][5]
    out = [[] for _ in reqs]
    held = {}
    for _ in range(n_dispatch):
        tokens, rows = model.forward([Sched(r, 1) for r in reqs], multi_step=S)
        assert len(tokens) == B_BUCKET * S
        lp = model.last_logprobs.numpy() if logprobs is not None else None
        for i, s in enumerate(rows):
            if s is None:
                continue
            r = s.request
            toks = [int(tokens[i * S + j]) for j in range(S)]
            out[reqs.index(r)].extend(toks)
            if lp is not None:
                logprobs[reqs.index(r)].extend(lp[i * S:(i + 1) * S].tolist())
            r.output_token_ids.extend(toks[:-1] + [None] if hold_last else toks)
            r.num_cached_tokens += S
            held[r.seq_id] = (r, toks[-1])
    for r, t in held.values():
        r.output_token_ids[-1] = t
    return out


def run(pkg, kind, S, n_dispatch, sampling=None, **kw):
    m = make_model(pkg, kind)
    return decode(pkg, m, prefill(pkg, m, **(sampling or {})), S, n_dispatch, **kw), m


@pytest.fixture(scope="module")
def jax_greedy_multi():
    """The JAX package's greedy multi-step tokens (S = 4, three dispatches;
    prompts of 14, 17 and 20 tokens on pages of 16, so every row crosses a
    page boundary inside a window)."""
    return run("jax", "gather", 4, 3)[0]


def test_multi_step_matches_sequential_greedy(jax_greedy_multi):
    seq, _ = run("port", "gather", 1, 8)
    mult, _ = run("port", "gather", 4, 2)
    assert mult == seq
    assert mult == [t[:8] for t in jax_greedy_multi]
    assert all(len(set(t)) > 1 for t in mult), "degenerate rows test nothing"


def test_multi_step_crosses_page_boundary(jax_greedy_multi):
    seq, m1 = run("port", "gather", 1, 12)
    mult, m2 = run("port", "gather", 4, 3)
    assert mult == seq
    assert mult == jax_greedy_multi
    # Every window token's KV reached the cache: the caches are equal too.
    ps = m1.engine_config.block_size
    assert torch.equal(m1.kv_cache[:, :-ps], m2.kv_cache[:, :-ps])


def test_multi_step_matches_sequential_sampled():
    """Per-(request, position) seeds advance by one a decode step on the host
    and by s on the device: the draws must be the same."""
    kw = dict(temperature=0.8, top_k=20, seed=7)
    seq, _ = run("port", "gather", 1, 8, sampling=kw)
    mult, _ = run("port", "gather", 4, 2, sampling=kw)
    assert mult == seq
    greedy, _ = run("port", "gather", 1, 8)
    assert mult != greedy, "the noise decided nothing"


def test_multi_step_logprobs_row_major():
    """Logprobs come out [B * S] like the tokens: row b's inner step s at
    b * S + s, equal to the sequential steps' (the same f32 operations)."""
    lp_seq = [[] for _ in PROMPTS]
    lp_mult = [[] for _ in PROMPTS]
    m1 = make_model("port", "gather", enable_logprobs=True)
    seq = decode("port", m1, prefill("port", m1), 1, 8, logprobs=lp_seq)
    m2 = make_model("port", "gather", enable_logprobs=True)
    mult = decode("port", m2, prefill("port", m2), 4, 2, logprobs=lp_mult)
    assert mult == seq
    np.testing.assert_array_equal(np.array(lp_mult), np.array(lp_seq))
    assert (np.array(lp_mult) <= 0).all() and np.isfinite(lp_mult).all()


def test_multi_step_feedback_chains_across_dispatches():
    seq, _ = run("port", "gather", 1, 8)
    mult, _ = run("port", "gather", 4, 2, hold_last=True)
    assert mult == seq


@pytest.fixture()
def count_pend(monkeypatch):
    """Counts the calls of the deferred-commit decode entry."""
    calls = []
    real = pa.paged_decode_attention_pend

    def spy(*a, **kw):
        calls.append(kw["npend"])
        return real(*a, **kw)
    monkeypatch.setattr(pa, "paged_decode_attention_pend", spy)
    return calls


def test_multi_step_deferred_commit_matches_sequential(monkeypatch, count_pend):
    """Deferred KV commit (no cache write inside the window, one scatter after
    it) gives the tokens of sequential single steps and of the fused
    multi-step run, across page boundaries, and the same cache. The JAX
    package's deferred run (its Pallas kernel in interpret mode) gives the
    same greedy tokens."""
    monkeypatch.setenv("SWIFTLLM_DEFER_KV", "1")
    seq, m1 = run("port", "kernel", 1, 8)
    assert count_pend == [], "single steps never defer"
    mult, m2 = run("port", "kernel", 4, 2)
    assert count_pend == [1, 1, 2, 2, 3, 3, 4, 4] * 2     # 2 layers a step
    assert mult == seq
    ps = m1.engine_config.block_size
    torch.testing.assert_close(m2.kv_cache[:, :-ps], m1.kv_cache[:, :-ps],
                               atol=0, rtol=0)

    monkeypatch.setenv("SWIFTLLM_DEFER_KV", "0")
    del count_pend[:]
    fused, m3 = run("port", "kernel", 4, 2)
    assert count_pend == []
    assert fused == mult
    assert torch.equal(m3.kv_cache[:, :-ps], m2.kv_cache[:, :-ps])

    monkeypatch.setenv("SWIFTLLM_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("SWIFTLLM_DEFER_KV", "1")
    want, _ = run("jax", "kernel", 4, 2)
    assert mult == want


@pytest.mark.parametrize("case", ["off_by_default", "gather_path", "fp8",
                                  "narrow_window", "wide_window"])
def test_defer_commit_gate(monkeypatch, case):
    """The gate of the JAX package's ``_defer_commit_ok``: the kernels' path,
    no fp8 cache, a window not narrower than the pending window, and
    SWIFTLLM_DEFER_KV=1 (read at each call)."""
    mc = LlamaModelConfig(**configs("kernel")[1])
    args = dict(use_kernels=True, fp8=False, multi_step=8)
    monkeypatch.setenv("SWIFTLLM_DEFER_KV", "1")
    assert llama._defer_commit_ok(mc, **args)
    want = False
    if case == "off_by_default":
        monkeypatch.delenv("SWIFTLLM_DEFER_KV")
    elif case == "gather_path":
        args["use_kernels"] = False
    elif case == "fp8":
        args["fp8"] = True
    elif case == "narrow_window":
        mc.sliding_window = 7
    else:
        mc.sliding_window, want = 8, True
    assert llama._defer_commit_ok(mc, **args) is want


# --- advance_decode_batch ----------------------------------------------------------

def test_advance_decode_batch_matches_jax():
    """A pure-decode batch of 8 rows (two pad rows at the tail) in a token
    bucket of 16, pages of 8: every field of the advanced batch, for s = 0 to
    5 (rows cross page boundaries; one seed wraps past 2^32)."""
    rng = np.random.default_rng(4)
    B, T, Pg, ps = 8, 16, 6, 8
    garbage = 400
    live = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    seq = np.where(live, rng.integers(1, 40, B), 0).astype(np.int32)
    seq[0], seq[1] = 8, 7                 # the first inner steps cross a page
    pos = np.zeros(T, np.int32)
    pos[:B] = np.where(live, seq - 1, 0)
    pt = rng.permutation(B * Pg).reshape(B, Pg).astype(np.int32)
    slots = np.full(T, garbage, np.int32)
    slots[:B] = np.where(live, pt[np.arange(B), pos[:B] // ps] * ps + pos[:B] % ps,
                         garbage)
    seeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    seeds[2] = 2**32 - 2
    fread = np.full(T, -1, np.int32)
    fread[1], fread[3] = 11, 13           # two rows read their token on-device
    fields = dict(
        token_ids=rng.integers(0, 100, T).astype(np.int32), positions=pos,
        kv_slots=slots, q_starts=np.where(live, np.arange(B), T).astype(np.int32),
        q_lens=live.astype(np.int32), seq_lens=seq, page_table=pt,
        sample_mask=live.copy(),
        temperature=rng.random(B).astype(np.float32),
        top_p=np.ones(B, np.float32), top_k=np.zeros(B, np.int32),
        feedback_read=fread,
        feedback_write=np.where(live, 20 + np.arange(B), 31).astype(np.int32))
    jb = jax_llama.StepBatch(seeds=jnp.asarray(seeds),
                             **{k: jnp.asarray(v) for k, v in fields.items()})
    pb = llama.StepBatch(seeds=torch.from_numpy(seeds.view(np.int32)),
                         **{k: torch.from_numpy(v) for k, v in fields.items()})
    for s in range(6):
        want = jax_llama.advance_decode_batch(jb, jnp.int32(s), page_size=ps,
                                              garbage_slot=garbage)
        got = llama.advance_decode_batch(pb, s, page_size=ps,
                                         garbage_slot=garbage)
        for name in list(fields) + ["seeds"]:
            g = getattr(got, name).numpy()
            w = np.asarray(getattr(want, name))
            if name == "seeds":
                g, w = g.astype(np.int64) & 0xFFFFFFFF, w.astype(np.int64)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} at s = {s}")
    assert int(got.seeds[2]) == 3         # wrapped


# --- the pend variant's plain version against the Pallas kernel -------------------

def test_pend_plain_matches_pallas_interpret():
    """The case of tests/test_paged_attention.py's deferred test: 8 rows (two
    pad rows), histories of 1 to 33 on scattered pages of 8, a window of 4
    inner steps that crosses page boundaries. At inner step s the Pallas
    kernel in deferred mode (interpret mode, its group-major pending layout)
    and the port's plain version (kv_pend [L, P, B, W], stale rows in the dead
    slots) see the same cache, which neither writes. atol 2e-5, rtol 1e-4 in
    float32. (Fused against deferred is the next test's, on the port's two
    plain versions.)"""
    rng = np.random.default_rng(7)
    B, n_q, n_kv, hd, ps, Pg = 8, 4, 2, 64, 8, 8
    W = 2 * n_kv * hd
    S = 4
    hist0 = np.array([17, 33, 5, 1, 9, 25, 0, 0])
    valid = hist0 > 0
    n_pages = B * Pg + 2
    cache = rng.normal(size=(2, n_pages * ps, W)).astype(np.float32) * 0.5
    pt = np.stack([np.arange(Pg) * B + b + 1 for b in range(B)]).astype(np.int32)
    q_all = rng.normal(size=(S, B, n_q, hd)).astype(np.float32) * 0.5
    kv_all = rng.normal(size=(S, B, W)).astype(np.float32) * 0.5

    def mkbatch(s):
        seq = np.where(valid, hist0 + s + 1, 0).astype(np.int32)
        pos = np.where(valid, hist0 + s, 0).astype(np.int32)
        slots = np.where(valid, pt[np.arange(B), pos // ps] * ps + pos % ps,
                         n_pages * ps - ps)
        return seq, jax_llama.StepBatch(
            token_ids=jnp.zeros(B, jnp.int32), positions=jnp.asarray(pos),
            q_starts=jnp.arange(B, dtype=jnp.int32),
            q_lens=jnp.asarray(valid.astype(np.int32)),
            seq_lens=jnp.asarray(seq), page_table=jnp.asarray(pt),
            kv_slots=jnp.asarray(slots.astype(np.int32)),
            sample_mask=jnp.asarray(valid))

    R, Bp, GB = decode_group_geometry(B)
    RW = R * W
    c_jax = jnp.asarray(cache)
    c_port = torch.from_numpy(cache.copy())
    pend_jax = np.zeros((2, GB, S * RW), np.float32)
    # The port's pending buffer starts full of stale rows: a step must read
    # only the slots below npend - 1.
    pend_port = torch.from_numpy(
        rng.normal(size=(2, S, B, W)).astype(np.float32) * 3)
    for s in range(S):
        seq, jb = mkbatch(s)
        kw = dict(n_kv=n_kv, page_size=ps, sm_scale=0.125, q_bucket=1,
                  kv_new=jnp.asarray(kv_all[s]), interpret=True)
        want = np.asarray(ragged_paged_attention(
            jnp.asarray(q_all[s]), c_jax, jnp.int32(1), jb,
            kv_pend=jnp.asarray(pend_jax), npend=jnp.int32(s + 1), **kw))
        got = pa.paged_decode_attention_pend(
            torch.from_numpy(q_all[s]), c_port, torch.from_numpy(kv_all[s]),
            pend_port, torch.from_numpy(pt),
            torch.from_numpy(valid.astype(np.int32)), torch.from_numpy(seq), 1,
            npend=s + 1, n_kv=n_kv, page_size=ps, sm_scale=0.125).numpy()
        np.testing.assert_allclose(got[valid], want[:B][valid], atol=2e-5,
                                   rtol=1e-4, err_msg=f"inner step {s}")
        assert not got[~valid].any(), "pad rows give zeros"
        pend_jax[1, :, s * RW:(s + 1) * RW] = kv_all[s].reshape(GB, RW)
        pend_port[1, s] = torch.from_numpy(kv_all[s])
    assert np.array_equal(c_port.numpy(), cache), "the plain version wrote the cache"


@pytest.mark.parametrize("window", [0, 6])
def test_pend_plain_matches_fused_plain(window):
    """The port's two plain versions against each other, with and without a
    sliding window: S sequential fused steps (each writes the cache) against
    S deferred steps on the untouched cache, exactly (the same keys in the
    same order)."""
    rng = np.random.default_rng(8)
    B, n_q, n_kv, hd, ps, Pg, S = 4, 4, 2, 16, 4, 6, 4
    W = 2 * n_kv * hd
    hist0 = np.array([9, 3, 1, 0])
    valid = torch.from_numpy((hist0 > 0).astype(np.int32))
    n_pages = B * Pg + 1
    g = torch.Generator().manual_seed(8)
    cache = torch.randn(1, n_pages * ps, W, generator=g)
    pt = torch.from_numpy(rng.permutation(B * Pg).reshape(B, Pg).astype(np.int32))
    c_fused = cache.clone()
    pend = torch.randn(1, S, B, W, generator=g) * 3
    kw = dict(n_kv=n_kv, page_size=ps, sm_scale=0.25, window=window)
    for s in range(S):
        q = torch.randn(B, n_q, hd, generator=g)
        kv_new = torch.randn(B, W, generator=g)
        seq = torch.from_numpy(np.where(hist0 > 0, hist0 + s + 1, 0).astype(np.int32))
        pos = (seq - 1).clamp_min(0).long()
        slots = torch.where(valid > 0, pt[torch.arange(B), pos // ps] * ps + pos % ps,
                            n_pages * ps - ps).int()
        want = pa.paged_decode_attention(q, c_fused, kv_new, pt, valid, seq,
                                         slots, 0, **kw)
        got = pa.paged_decode_attention_pend(q, cache, kv_new, pend, pt, valid,
                                             seq, 0, npend=s + 1, **kw)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        pend[0, s] = kv_new


def test_pend_entry_checks_its_arguments():
    cache = torch.zeros(1, 32, 64)
    q = torch.zeros(2, 2, 16)
    kv_new = torch.zeros(2, 64)
    pend = torch.zeros(1, 4, 2, 64)
    pt = torch.zeros(2, 2, dtype=torch.int32)
    ones = torch.ones(2, dtype=torch.int32)
    kw = dict(n_kv=2, page_size=8, sm_scale=1.0)
    pa.paged_decode_attention_pend(q, cache, kv_new, pend, pt, ones, ones, 0,
                                   npend=4, **kw)
    for npend in (0, 5):
        with pytest.raises(ValueError, match="npend"):
            pa.paged_decode_attention_pend(q, cache, kv_new, pend, pt, ones,
                                           ones, 0, npend=npend, **kw)
    with pytest.raises(ValueError, match="pend shapes"):
        pa.paged_decode_attention_pend(q, cache, kv_new, pend[:, :, :1], pt,
                                       ones, ones, 0, npend=1, **kw)
    fp8 = torch.zeros(1, 32, 64 + 128).to(torch.float8_e4m3fn)
    with pytest.raises(TypeError, match="unscaled"):
        pa.paged_decode_attention_pend(q, fp8, kv_new, pend, pt, ones, ones, 0,
                                       npend=1, **kw)


# --- the engine -------------------------------------------------------------------

E_MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
            head_dim=16, ffn_inter_dim=128, vocab_size=256,
            max_position_embeddings=2048, rms_norm_eps=1e-5)
E_EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=16,
            num_hbm_blocks=64, num_cpu_blocks=0, max_blocks_per_seq=16,
            max_batch_size=8, max_tokens_in_batch=128, prefill_chunk_size=32,
            max_seqs_in_block_table=32, preemption_mode="recompute",
            use_pallas=False, enable_logprobs=True)


def serve(requests, ec_kw=None, mc_kw=None, timeout=120):
    """The requests through a fresh port Engine on the CPU; returns (engine,
    [(request, token ids), ...]) in submission order."""
    async def body():
        e = Engine(EngineConfig(**dict(E_EC, **(ec_kw or {}))),
                   LlamaModelConfig(**dict(E_MC, **(mc_kw or {}))), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        loops = asyncio.create_task(e.start_all_event_loops())
        try:
            outs = await asyncio.wait_for(asyncio.gather(
                *[e.add_request_and_wait(r) for r in requests]), timeout)
        finally:
            loops.cancel()
        return e, outs
    return asyncio.run(body())


def engine_requests(lens=(8, 10, 3), temperature=0.0):
    return [RawRequest("", n, temperature=temperature, seed=123 + i,
                       prompt_token_ids=[(i * 11 + j) % 256 for j in range(12)])
            for i, n in enumerate(lens)]


def assert_same_outputs(base, ms):
    for (ra, a), (rb, b) in zip(base, ms):
        assert a == b
        assert len(rb.output_logprobs) == len(b)
        np.testing.assert_allclose(rb.output_logprobs, ra.output_logprobs,
                                   atol=1e-6, rtol=0)
        assert all(lp is not None and lp <= 0 for lp in rb.output_logprobs)


def test_engine_multi_step_matches_single_greedy():
    # Output lengths that are no multiples of S: a row with fewer than S
    # tokens left sends the scheduler back to single steps for the tail.
    _, base = serve(engine_requests())
    eng, ms = serve(engine_requests(), dict(multi_step_decode=4))
    assert_same_outputs(base, ms)
    assert [len(t) for _, t in ms] == [8, 10, 3]
    assert eng.stats.num_steps < eng.stats.num_tokens_generated


def test_engine_multi_step_matches_single_sampled():
    reqs = lambda: engine_requests(lens=(8, 8, 8), temperature=0.8)  # noqa: E731
    _, base = serve(reqs())
    _, ms = serve(reqs(), dict(multi_step_decode=4))
    assert_same_outputs(base, ms)
    _, greedy = serve(engine_requests(lens=(8, 8, 8)))
    assert [t for _, t in ms] != [t for _, t in greedy]


def test_engine_multi_step_eos_mid_span():
    """The dummy model's second output token declared EOS: the multi-step
    engine cuts the window there, tokens and logprobs alike."""
    reqs = lambda: [RawRequest("", 8, prompt_token_ids=list(range(5)))]  # noqa: E731
    _, outs = serve(reqs(), mc_kw=dict(eos_token_id=None))
    full_req, full = outs[0]
    assert len(full) == 8
    _, outs = serve(reqs(), dict(multi_step_decode=4),
                    dict(eos_token_id=full[1]))
    req, got = outs[0]
    assert req.stopped_on_eos
    assert got == full[:2]
    np.testing.assert_allclose(req.output_logprobs, full_req.output_logprobs[:2],
                               atol=1e-6, rtol=0)


def test_engine_multi_step_page_pressure_falls_back():
    """A pool too small for S more tokens a row: the scheduler falls back to
    single steps (or preempts and recomputes) and every request finishes
    with the single-step engine's tokens."""
    small = dict(num_hbm_blocks=6, max_blocks_per_seq=4)
    reqs = lambda: [RawRequest("", 16, prompt_token_ids=[(i * 7 + j) % 256  # noqa: E731
                                                         for j in range(30)])
                    for i in range(3)]
    _, base = serve(reqs(), small)
    eng, ms = serve(reqs(), dict(small, multi_step_decode=4))
    for (_, a), (_, b) in zip(base, ms):
        assert a == b and len(b) == 16
    assert eng.model.hbm_block_mgrs[0].num_free_blocks == 6
