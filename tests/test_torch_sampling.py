"""The port's sampler and logprob head against the JAX package's, on the CPU.

- ``sample_tokens`` with the JAX package's Gumbel noise injected
  (``jax.random.gumbel(jax.random.key(seed), (C,))`` per row) must pick the
  same tokens as the JAX package's ``sample_tokens`` in its exact top-k mode
  (``EXACT_TOPK``, set on the module: the environment is read at import), over
  greedy, temperature, top-k, top-p and mixed rows, and over logits with
  ties (bf16-rounded values), where ``lax.top_k``'s order (the lower index
  first) decides ranks.
- The port's own noise is a stateless hash of (seed, column): the same for
  the same seed, different across seeds, a function of the low 32 bits only,
  and the same for ``seed + s`` whether the host or ``advance_decode_batch``
  adds the ``s``. Its draws follow the masked softmax: a chi-square test over
  40,000 seeds, and the Gumbel moments.
- The logprob head (the raw log-softmax of the chosen token) within 1e-5 of
  the JAX package's in float32, at the function and through one model step.

Inputs come from numpy generators with fixed seeds.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import jax.numpy as jnp
import torch

from swiftllm_tpu.models import sampling as jax_sampling
from swiftllm_tpu_torch.models import sampling
from swiftllm_tpu_torch.models.llama import StepBatch, advance_decode_batch

B, V = 24, 1000
C = sampling.MAX_CAND


@pytest.fixture()
def exact_topk(monkeypatch):
    monkeypatch.setattr(jax_sampling, "EXACT_TOPK", True)


def jax_gumbel(seeds: np.ndarray, n: int) -> np.ndarray:
    return np.array(jax.vmap(lambda s: jax.random.gumbel(
        jax.random.key(s), (n,), jnp.float32))(jnp.asarray(seeds)))


def knobs(kind: str, rng):
    """temperature, top_p, top_k for B rows of one kind."""
    t = np.zeros(B, np.float32)
    p = np.ones(B, np.float32)
    k = np.zeros(B, np.int32)
    if kind in ("temperature", "top_k", "top_p", "ties"):
        t[:] = rng.uniform(0.3, 1.5, B)
    if kind in ("top_k", "ties"):
        k[:] = rng.integers(1, 40, B)
    if kind == "top_p":
        p[:] = rng.uniform(0.2, 0.95, B)
    if kind == "mixed":
        t[:] = np.where(rng.random(B) < 0.5, 0.0, rng.uniform(0.3, 1.5, B))
        k[:] = np.where(rng.random(B) < 0.5, 0, rng.integers(1, 300, B))
        p[:] = np.where(rng.random(B) < 0.5, 1.0, rng.uniform(0.2, 0.95, B))
    return t, p, k


@pytest.mark.parametrize("kind", ["greedy", "temperature", "top_k", "top_p",
                                  "mixed", "ties"])
def test_sample_tokens_match_jax_with_injected_noise(exact_topk, kind):
    rng = np.random.default_rng(["greedy", "temperature", "top_k", "top_p",
                                 "mixed", "ties"].index(kind))
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    if kind == "ties":
        # Values as a bf16 product leaves them: about 40 distinct values
        # among the top 256, so ranks and the nucleus depend on tie order.
        logits = torch.from_numpy(logits).bfloat16().float().numpy()
    t, p, k = knobs(kind, rng)
    seeds = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_sampling.sample_tokens(
        jnp.asarray(logits), temperature=jnp.asarray(t), top_p=jnp.asarray(p),
        top_k=jnp.asarray(k), seeds=jnp.asarray(seeds), v_local=V,
        tp_axis="tp", tp_size=1, tp_rank=0))
    got = sampling.sample_tokens(
        torch.from_numpy(logits), temperature=torch.from_numpy(t),
        top_p=torch.from_numpy(p), top_k=torch.from_numpy(k),
        seeds=torch.from_numpy(seeds.view(np.int32)),
        gumbel=torch.from_numpy(jax_gumbel(seeds, C)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "greedy":
        # The noise decided something: not every sampled row is the argmax.
        assert (want != logits.argmax(-1))[t > 0].any()
    np.testing.assert_array_equal(want[t <= 0], logits.argmax(-1)[t <= 0])


@pytest.mark.parametrize("ties,rows", [(False, 8), (True, 8),
                                       (True, 2 * sampling.TOPK_ROWS + 3)],
                         ids=["distinct", "ties", "row_blocks"])
def test_top_candidates_order_is_lax_top_k(ties, rows):
    """lax.top_k's order, ties included; with more rows than TOPK_ROWS (a
    verify step's head) the keys are built a block of rows at a time."""
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(rows, 5000)) * 2).astype(np.float32)
    if ties:
        logits = np.round(logits * 4) / 4        # many equal values, and -0.0
        logits[0, :7] = -0.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(logits), C)
    got_v, got_i = sampling.top_candidates(torch.from_numpy(logits), C)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_vocab_smaller_than_the_candidate_count(exact_topk):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 100)).astype(np.float32)
    seeds = np.arange(6, dtype=np.uint32)
    t = np.full(6, 0.9, np.float32)
    want = np.asarray(jax_sampling.sample_tokens(
        jnp.asarray(logits), temperature=jnp.asarray(t), top_p=jnp.ones(6),
        top_k=jnp.zeros(6, jnp.int32), seeds=jnp.asarray(seeds), v_local=100,
        tp_axis="tp", tp_size=1, tp_rank=0))
    got = sampling.sample_tokens(
        torch.from_numpy(logits), temperature=torch.from_numpy(t),
        top_p=torch.ones(6), top_k=torch.zeros(6, dtype=torch.int32),
        seeds=torch.from_numpy(seeds.view(np.int32)),
        gumbel=torch.from_numpy(jax_gumbel(seeds, 100)))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the port's own noise ----------------------------------------------------------

def test_noise_is_a_function_of_the_seed():
    seeds = torch.tensor([0, 1, 7, 7, 2**31 - 1, 12345], dtype=torch.int32)
    a = sampling.gumbel_noise(seeds, C)
    b = sampling.gumbel_noise(seeds.clone(), C)
    assert a.dtype == torch.float32 and a.shape == (6, C)
    assert torch.equal(a, b)
    assert torch.equal(a[2], a[3])
    assert torch.isfinite(a).all()
    # A row's first 64 columns are the same whatever the width asked for.
    assert torch.equal(sampling.gumbel_noise(seeds, 64), a[:, :64])


def test_noise_differs_across_seeds_and_columns():
    seeds = torch.arange(512, dtype=torch.int32)       # consecutive, as steps are
    g = sampling.gumbel_noise(seeds, C)
    assert len({tuple(r) for r in g[:, :4].tolist()}) == 512
    # No row is a shifted copy of its neighbour, and rows do not correlate.
    assert not torch.equal(g[0, 1:], g[1, :-1])
    corr = np.corrcoef(g.numpy())
    assert np.abs(corr - np.eye(512)).max() < 0.35
    assert abs(np.corrcoef(g[:, :-1].flatten(), g[:, 1:].flatten())[0, 1]) < 0.02


def test_noise_takes_the_low_32_bits_in_any_dtype():
    u = np.array([0, 1, 2**31, 2**32 - 1, 3000000000], dtype=np.uint32)
    as_i32 = sampling.gumbel_noise(torch.from_numpy(u.view(np.int32)), 32)
    as_i64 = sampling.gumbel_noise(torch.from_numpy(u.astype(np.int64)), 32)
    beyond = sampling.gumbel_noise(torch.from_numpy(u.astype(np.int64) + 2**32), 32)
    assert torch.equal(as_i32, as_i64)
    assert torch.equal(as_i32, beyond)


def test_seed_plus_s_is_the_same_draw_from_host_or_device():
    """Inner step s of a multi-step window (advance_decode_batch: seeds + s on
    the device, wrapping at 2^32) draws what the s-th sequential step draws
    (``build_step_batch``'s seed + s on the host)."""
    u = np.array([5, 2**31 - 2, 2**32 - 3, 2**32 - 1], dtype=np.uint32)
    n = len(u)
    batch = StepBatch(
        token_ids=torch.zeros(n, dtype=torch.int32),
        positions=torch.arange(n, dtype=torch.int32),
        kv_slots=torch.zeros(n, dtype=torch.int32),
        q_starts=torch.arange(n, dtype=torch.int32),
        q_lens=torch.ones(n, dtype=torch.int32),
        seq_lens=torch.arange(1, n + 1, dtype=torch.int32),
        page_table=torch.zeros(n, 2, dtype=torch.int32),
        sample_mask=torch.ones(n, dtype=torch.bool),
        seeds=torch.from_numpy(u.view(np.int32)),
        feedback_read=torch.full((n,), -1, dtype=torch.int32),
        feedback_write=torch.arange(n, dtype=torch.int32))
    for s in range(6):
        dev = advance_decode_batch(batch, s, page_size=8, garbage_slot=64).seeds
        host = (u.astype(np.uint64) + s).astype(np.uint32)      # wraps
        np.testing.assert_array_equal(dev.numpy() & 0xFFFFFFFF, host)
        assert torch.equal(sampling.gumbel_noise(dev, C),
                           sampling.gumbel_noise(torch.from_numpy(host.view(np.int32)), C))


def test_gumbel_moments():
    g = sampling.gumbel_noise(torch.arange(4096, dtype=torch.int32), C).double()
    n = g.numel()                                       # about a million draws
    assert abs(g.mean().item() - 0.5772157) < 5 * 1.2825 / np.sqrt(n)
    assert abs(g.var().item() - np.pi**2 / 6) < 0.02
    # Uniformity of exp(-exp(-g)), the underlying uniform: 16 equal bins.
    u = torch.exp(-torch.exp(-g)).flatten()
    counts = torch.histc(u, bins=16, min=0.0, max=1.0).numpy()
    chi2 = ((counts - n / 16) ** 2 / (n / 16)).sum()
    assert chi2 < 50, chi2               # 15 degrees of freedom: p about 1e-5


@pytest.mark.parametrize("knob", ["temperature", "top_k", "top_p", "all"])
def test_own_noise_draws_follow_the_masked_softmax(knob):
    """40,000 rows of the same logits with consecutive seeds: the token
    counts against the distribution the knobs define (temperature, the top-k
    ranks, the nucleus prefix), by chi-square."""
    rng = np.random.default_rng(3)
    n, v = 40000, 64
    row = rng.normal(size=v).astype(np.float32)
    temp = 0.7
    top_k = 12 if knob in ("top_k", "all") else 0
    top_p = 0.9 if knob in ("top_p", "all") else 1.0
    order = np.argsort(-row, kind="stable")
    z = row[order].astype(np.float64) / temp
    if top_k:
        z[top_k:] = -np.inf
    pr = np.exp(z - z.max())
    pr /= pr.sum()
    keep = (np.cumsum(pr) - pr) < top_p
    pr = np.where(keep, pr, 0.0)
    pr /= pr.sum()
    want = np.zeros(v)
    want[order] = pr

    got = sampling.sample_tokens(
        torch.from_numpy(row).expand(n, v).contiguous(),
        temperature=torch.full((n,), temp), top_p=torch.full((n,), top_p),
        top_k=torch.full((n,), top_k, dtype=torch.int32),
        seeds=torch.arange(1000, 1000 + n, dtype=torch.int32))
    counts = np.bincount(got.numpy(), minlength=v).astype(np.float64)
    assert counts[want == 0].sum() == 0, "a masked token was drawn"
    live = want > 0
    chi2 = ((counts[live] - n * want[live]) ** 2 / (n * want[live])).sum()
    dof = live.sum() - 1
    # Mean dof, standard deviation sqrt(2 dof): 5 deviations above the mean.
    assert chi2 < dof + 5 * np.sqrt(2 * dof), (chi2, dof)
    assert live.sum() >= 5


# --- the logprob head ----------------------------------------------------------------

def test_chosen_logprobs_match_log_softmax():
    rng = np.random.default_rng(9)
    logits = (rng.normal(size=(B, V)) * 4).astype(np.float32)
    tokens = rng.integers(0, V, B).astype(np.int32)
    want = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))[
        np.arange(B), tokens]
    got = sampling.chosen_logprobs(torch.from_numpy(logits), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert (got <= 0).all()


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_model_step_logprobs_match_jax(temperature):
    """One prefill step and one decode step through both LlamaModels with
    ``enable_logprobs``: the port's logprobs within 1e-5 of the JAX package's
    head (llama.py, ``return_logprobs``) for the tokens each side chose. With
    temperature > 0 the two sides draw different tokens (different noise), so
    the port's logprob is held against the JAX step's log-softmax at the
    PORT's token, from the JAX logits."""
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
    from tests.test_torch_llama import EC, MC, scaled_params

    ec = dict(EC, enable_logprobs=True)
    jm = JaxLlamaModel(JaxEngineConfig(**ec), JaxModelConfig(**MC))
    jm.load_weights()
    jm.init_kvcache_and_swap()
    tree = scaled_params(jm.params, np.random.default_rng(0))
    jm.params = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                             jm.params, tree)
    pm = LlamaModel(EngineConfig(**ec), LlamaModelConfig(**MC), device="cpu")
    pm.params = params_from_numpy(tree, "cpu")
    pm.init_kvcache_and_swap()

    prompts = [[(7 * i + 3 * j) % 120 + 1 for j in range(n)] for i, n in enumerate((5, 11, 8))]

    def reqs(Req, Raw):
        out = []
        for i, p in enumerate(prompts):
            r = Req(Raw("", 4, temperature=temperature, seed=3 + i))
            r.set_prompt_token_ids(p)
            r.seq_id = i
            out.append(r)
        return out

    jr, pr = reqs(JaxRequest, JaxRawRequest), reqs(Request, RawRequest)
    for step in range(2):
        n_tok = (lambda r: r.prompt_len) if step == 0 else (lambda r: 1)
        jt, jrows, jlogits = jm.forward([JaxScheduledSeq(r, n_tok(r)) for r in jr],
                                        return_logits=True)
        jlp = np.asarray(jm.last_logprobs)
        pt, prows, plogits = pm.forward([ScheduledSeq(r, n_tok(r)) for r in pr],
                                        return_logits=True)
        plp = pm.last_logprobs.numpy()
        live = [i for i, s in enumerate(prows) if s is not None]
        assert live == [i for i, s in enumerate(jrows) if s is not None]
        np.testing.assert_allclose(plogits[live], jlogits[live], atol=1e-4, rtol=1e-4)
        at_port_token = np.asarray(jax.nn.log_softmax(jnp.asarray(jlogits), -1))[
            np.arange(len(pt)), pt]
        np.testing.assert_allclose(plp[live], at_port_token[live], atol=1e-5, rtol=0)
        if temperature == 0:
            np.testing.assert_array_equal(pt[live], jt[live])
            np.testing.assert_allclose(plp[live], jlp[live], atol=1e-5, rtol=0)
        assert (plp[live] <= 0).all() and np.isfinite(plp[live]).all()
        # Both sides go on from the port's tokens, so the next step's inputs agree.
        for rs in (jr, pr):
            for i, r in zip(live, rs):
                r.output_token_ids.append(int(pt[i]))
                r.num_cached_tokens += n_tok(r)
