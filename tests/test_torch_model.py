"""The port's LlamaModel end to end against the JAX package's, on a tiny
random HF Llama checkpoint built locally (no download), which the port loads
through its own safetensors getter.

Greedy tokens must be equal, exactly: f32 on both sides, whole prompts and
chunked prefill, both port attention paths. The JAX side is
``LlamaModel(use_pallas=False)``; HF ``generate`` is the golden for both.
"""

import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

from swiftllm_tpu_torch.config import EngineConfig
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from tests.test_llama_golden import (PROMPTS, hf_greedy, make_model,  # noqa: F401
                                     run_ours, tiny_ckpt)


def make_port_model(path, use_pallas):
    ec = EngineConfig(model_path=path, dtype="float32", block_size=4,
                      max_blocks_per_seq=16, max_tokens_in_batch=64,
                      num_hbm_blocks=32, prefill_chunk_size=8,
                      preemption_mode="recompute", use_pallas=use_pallas)
    m = LlamaModel(ec, device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    return m


def run_port(m, prompts, n_steps, chunked=False, chunk=4):
    """``run_ours`` of tests/test_llama_golden.py with the port's classes."""
    reqs = []
    for i, p in enumerate(prompts):
        r = Request(RawRequest("", n_steps))
        r.set_prompt_token_ids(list(p))
        r.seq_id = i
        reqs.append(r)

    def apply(tokens, rows):
        for i, s in enumerate(rows):
            if s is None:
                continue
            if s.samples_token:
                s.request.output_token_ids.append(int(tokens[i]))
            s.request.num_cached_tokens += s.n_tokens

    if chunked:
        while any(r.is_prefill_stage() for r in reqs):
            sched = [ScheduledSeq(r, min(chunk, r.num_uncached_tokens()))
                     for r in reqs if r.num_uncached_tokens() > 0]
            apply(*m.forward(sched))
    else:
        apply(*m.forward([ScheduledSeq(r, r.prompt_len) for r in reqs]))
    while any(not r.is_finished() for r in reqs):
        apply(*m.forward([ScheduledSeq(r, 1) for r in reqs if not r.is_finished()]))
    return [r.output_token_ids for r in reqs]


@pytest.fixture(scope="module")
def jax_tokens(tiny_ckpt):  # noqa: F811
    path, hf_model, _ = tiny_ckpt
    m = make_model(path)
    want = {"whole": run_ours(m, PROMPTS, 6)}
    m = make_model(path)
    want["chunked"] = run_ours(m, PROMPTS, 6, chunked=True, chunk=4)
    for p, o in zip(PROMPTS, want["whole"]):
        assert o == hf_greedy(hf_model, p, 6)
    return want


@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_greedy_tokens_match_jax(tiny_ckpt, jax_tokens, mode, use_pallas):  # noqa: F811
    path, _, _ = tiny_ckpt
    got = run_port(make_port_model(path, use_pallas), PROMPTS, 6,
                   chunked=mode == "chunked", chunk=4)
    assert got == jax_tokens[mode]


REFUSED = {
    "logprobs": (dict(enable_logprobs=True), {}),
    "swap": (dict(preemption_mode="swap", num_cpu_blocks=8), {}),
    "prefix_caching": (dict(enable_prefix_caching=True), {}),
    "multi_step": (dict(multi_step_decode=4), {}),
    "spec_decode": (dict(enable_spec_decode=True), {}),
    "kv_quant": (dict(kv_quant="fp8", block_size=32), {}),
    "sliding_window": ({}, dict(sliding_window=64)),
    "lora": (dict(lora_paths="dummy:a"), {}),
    "tensor_parallel": (dict(tp_size=2), {}),
}
# Refused at first, run since: the model must now build with them (and, for
# logprobs, multi-step decode and spec decode, run a step).
NOW_RUN = {"kv_quant", "sliding_window", "logprobs", "multi_step",
           "prefix_caching", "spec_decode", "swap", "lora"}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_features_refused(name):
    """Every feature the port does not run yet raises NotImplementedError at
    model construction, naming the ROADMAP item that brings it; the fp8 KV
    cache, the sliding window, logprobs, multi-step decode, prefix caching,
    spec decode, swap and LoRA, refused at first, are accepted: prefix
    caching reaches the block manager, swap allocates the host pool, LoRA
    loads its adapters, and logprobs, multi-step, spec decode and LoRA run a
    step."""
    import torch

    from swiftllm_tpu_torch.config import LlamaModelConfig
    ec_kw, mc_kw = REFUSED[name]
    mc = LlamaModelConfig(num_layers=1, num_q_heads=2, num_kv_heads=1,
                          hidden_size=16, head_dim=8, ffn_inter_dim=32,
                          vocab_size=32, max_position_embeddings=64,
                          rms_norm_eps=1e-5, **mc_kw)
    ec = EngineConfig(**dict(dict(use_dummy=True, preemption_mode="recompute"),
                             **ec_kw))
    if name in NOW_RUN:
        m = LlamaModel(ec, mc, device="cpu")
        m.init_kvcache_and_swap(2)
        fp8 = name == "kv_quant"
        assert m.kv_cache.dtype == (torch.float8_e4m3fn if fp8 else torch.bfloat16)
        assert m.kv_cache.shape[2] == 2 * 1 * 8 + (128 if fp8 else 0)
        if name == "prefix_caching":
            assert m.hbm_block_mgrs[0].prefix_caching
        if name == "swap":
            assert tuple(m.cpu_cache.shape) == (1, 8 * 16, 16)
            assert m.cpu_cache.dtype == m.kv_cache.dtype
            assert m.cpu_block_mgr.num_free_blocks == 8
        if name == "lora":
            m.load_weights()
            assert m.lora_slots == {"a": 1} and m.lora_targets == ("wq", "wv", "wo")
            r = Request(RawRequest("", 8))
            r.set_prompt_token_ids([3, 1, 4, 1, 5])
            r.seq_id, r.lora_slot = 0, 1
            tokens, rows = m.forward([ScheduledSeq(r, r.prompt_len)])
            assert rows[0].request is r and 0 <= tokens[0] < 32
        if name == "spec_decode":
            m.load_weights()
            r = Request(RawRequest("", 8))
            r.set_prompt_token_ids([3, 1, 4, 1, 5])
            r.seq_id = 0
            tokens, _ = m.forward([ScheduledSeq(r, r.prompt_len)])
            r.output_token_ids.append(int(tokens[0]))
            r.num_cached_tokens = r.prompt_len
            tokens, rows = m.forward([ScheduledSeq(r, 3, drafts=(2, 6))])
            S1 = m.last_key.spec
            assert S1 == 8 and m.last_key.q_len == S1    # next_pow2(spec_k + 1)
            assert rows[0].request is r and len(tokens) == len(rows) * S1
            assert all(0 <= t < 32 for t in tokens[:3])
        if name in ("logprobs", "multi_step"):
            m.load_weights()
            r = Request(RawRequest("", 8))
            r.set_prompt_token_ids([3, 1, 4, 1, 5])
            r.seq_id = 0
            tokens, _ = m.forward([ScheduledSeq(r, r.prompt_len)])
            r.output_token_ids.append(int(tokens[0]))
            r.num_cached_tokens = r.prompt_len
            S = ec.multi_step_decode
            tokens, rows = m.forward([ScheduledSeq(r, 1)], multi_step=S)
            assert rows[0].request is r and len(tokens) == len(rows) * S
            assert all(0 <= t < 32 for t in tokens[:S])
            if name == "logprobs":
                lp = m.last_logprobs.numpy()
                assert lp.shape == tokens.shape and lp[0] <= 0
            else:
                assert m.last_key.steps == S and m.last_logprobs is None
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        LlamaModel(ec, mc, device="cpu")


def test_default_device_needs_a_gpu():
    """The model runs on the card unless the caller asks for the CPU: with
    no GPU, the default device raises instead of falling back."""
    import torch

    from swiftllm_tpu_torch.config import LlamaModelConfig
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    mc = LlamaModelConfig(num_layers=1, num_q_heads=2, num_kv_heads=1,
                          hidden_size=16, head_dim=8, ffn_inter_dim=32,
                          vocab_size=32, max_position_embeddings=64,
                          rms_norm_eps=1e-5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaModel(EngineConfig(use_dummy=True, preemption_mode="recompute"), mc)
