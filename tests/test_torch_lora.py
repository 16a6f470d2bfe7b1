"""Multi-LoRA in the port, on the CPU.

- The port of ``tests/test_lora.py::test_lora_mixed_batch_matches_merged_hf``
  at tp = 1: a mixed batch (a base row and two adapter rows, adapters read
  from peft files) through one step, each row's logits against an HF model
  with that adapter merged into its weights, atol 5e-4 / rtol 2e-3 (f32).
- The port's step against the JAX step on the same parameters and adapters
  (``params_from_numpy`` of the JAX tree): a mixed prefill step's logits
  and then decode steps' tokens, one of them a multi-step window, f32,
  atol 1e-5 / rtol 1e-4 on the logits (the same function; ``lora_add``
  rounds once where the reference rounds twice, and f32 sums run in
  another order) and tokens exactly.
- ``lora_add`` in bf16 against the reference's form (every adapter's update
  for every token, selected by slot): within one bf16 rounding of the sum.
- The port of ``tests/test_lora.py::test_engine_dummy_loras_route_and_reject``
  on the port's engine, and ``make_dummy_loras`` byte-equal across packages.
- The Qwen2 cases of ``tests/test_qwen2_golden.py`` (config parsing, greedy
  tokens and prefill logits against HF) on the port.
"""

import asyncio

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax

from swiftllm_tpu.server.scheduler import ScheduledSeq as JaxScheduledSeq
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu.server.structs import Request as JaxRequest
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models.llama import lora_add, lora_select
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_llama_golden import hf_greedy, make_model
from tests.test_lora import _merged_hf, lora_setup  # noqa: F401
from tests.test_qwen2_golden import PROMPTS as QWEN_PROMPTS
from tests.test_qwen2_golden import tiny_qwen2  # noqa: F401
from tests.test_torch_model import make_port_model, run_port

PROMPT = [1, 7, 3, 9, 11, 5]


def port_lora_model(root, **kw):
    ec = EngineConfig(model_path=str(root / "base"), dtype="float32",
                      block_size=4, max_blocks_per_seq=16,
                      max_tokens_in_batch=64, num_hbm_blocks=32,
                      num_cpu_blocks=32, prefill_chunk_size=8,
                      lora_paths=f"a1={root / 'a1'},a2={root / 'a2'}", **kw)
    m = LlamaModel(ec, device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    return m


def mixed_requests(req_cls, raw_cls, n_out=1):
    """A base row and one row per adapter, the same prompt."""
    reqs = []
    for i, slot in enumerate([0, 1, 2]):
        r = req_cls(raw_cls("", n_out))
        r.set_prompt_token_ids(list(PROMPT))
        r.seq_id, r.lora_slot = i, slot
        reqs.append(r)
    return reqs


def test_lora_mixed_batch_matches_merged_hf(lora_setup):  # noqa: F811
    root, hf, _ = lora_setup
    m = port_lora_model(root)
    assert m.lora_slots == {"a1": 1, "a2": 2}
    reqs = mixed_requests(Request, RawRequest)
    _, _, logits = m.forward([ScheduledSeq(r, r.prompt_len) for r in reqs],
                             return_logits=True)
    expected = [hf, _merged_hf(hf, root / "a1"), _merged_hf(hf, root / "a2")]
    with torch.no_grad():
        for i, em in enumerate(expected):
            want = em(torch.tensor([PROMPT])).logits[0, -1].numpy()
            np.testing.assert_allclose(logits[i][:len(want)], want,
                                       atol=5e-4, rtol=2e-3,
                                       err_msg=f"row {i}")


def _apply(reqs, tokens, rows, steps=1):
    """Append each live row's tokens (S of them under a window of S)."""
    for i, s in enumerate(rows):
        if s is not None and s.samples_token:
            s.request.output_token_ids.extend(
                int(t) for t in tokens[i * steps:(i + 1) * steps])
            s.request.num_cached_tokens += s.n_tokens + steps - 1


def test_lora_step_matches_jax(lora_setup):  # noqa: F811
    """The same mixed prefill step and decode steps through the JAX model
    (gather path, f32) and the port (kernels' plain versions, f32) on the JAX
    model's parameters and adapters."""
    root, _, _ = lora_setup
    paths = f"a1={root / 'a1'},a2={root / 'a2'}"
    jm = make_model(str(root / "base"), lora_paths=paths, multi_step_decode=2)
    pm = port_lora_model(root, multi_step_decode=2)
    tree = jax.tree.map(np.asarray, jax.device_get(jm.params))
    pm.params = params_from_numpy(tree, "cpu")
    assert pm.lora_targets == jm.lora_targets == ("w_gate", "wo", "wq", "wv")

    jreqs = mixed_requests(JaxRequest, JaxRawRequest, 6)
    preqs = mixed_requests(Request, RawRequest, 6)
    jt, jrows, jl = jm.forward([JaxScheduledSeq(r, r.prompt_len) for r in jreqs],
                               return_logits=True)
    pt, prows, pl = pm.forward([ScheduledSeq(r, r.prompt_len) for r in preqs],
                               return_logits=True)
    np.testing.assert_allclose(pl[:3], jl[:3], atol=1e-5, rtol=1e-4)
    assert not np.allclose(pl[0], pl[1], atol=1e-2), "adapter a1 changes nothing"
    _apply(jreqs, jt, jrows)
    _apply(preqs, pt, prows)
    for steps in (1, 2, 1):      # a single step, a window of 2, a single step
        jt, jrows = jm.forward([JaxScheduledSeq(r, 1) for r in jreqs],
                               multi_step=steps)
        pt, prows = pm.forward([ScheduledSeq(r, 1) for r in preqs],
                               multi_step=steps)
        _apply(jreqs, jt, jrows, steps)
        _apply(preqs, pt, prows, steps)
    want = [r.output_token_ids for r in jreqs]
    assert [r.output_token_ids for r in preqs] == want
    assert all(len(t) == 5 for t in want) and want[0] != want[1]


def test_lora_add_matches_reference_form():
    """bf16: lora_add (one rounding of y + update) against the reference's
    form (the update rounded to bf16, then added to y and rounded again):
    within one bf16 ulp of the larger, plus the update's own ulp."""
    rng = np.random.default_rng(8)
    T, n, r, din, dout = 12, 3, 4, 32, 48
    x = torch.from_numpy(rng.normal(size=(T, din)).astype(np.float32)).bfloat16()
    y = torch.from_numpy(rng.normal(size=(T, dout)).astype(np.float32)).bfloat16()
    A = torch.from_numpy(rng.normal(size=(n, r, din)).astype(np.float32) * 0.2).bfloat16()
    B = torch.from_numpy(rng.normal(size=(n, dout, r)).astype(np.float32) * 0.2).bfloat16()
    ids = torch.tensor([0, 1, 2, 3] * 3, dtype=torch.int32)
    scale = torch.tensor([2.0, 0.5, 1.25])
    sel = lora_select(ids, scale)
    # The reference's form, rounding where it rounds.
    z = torch.einsum("td,nrd->tnr", x.float(), A.float()).bfloat16()
    yl = torch.einsum("tnr,nor->tno", z.float(), B.float())
    upd = torch.einsum("tno,tn->to", yl, sel).bfloat16()
    want = (y.float() + upd.float()).bfloat16()
    got = lora_add(y.clone(), x, A, B, sel)
    ulp = 2.0 ** -7 * (want.float().abs() + upd.float().abs())
    assert ((got.float() - want.float()).abs() <= ulp + 1e-6).all()
    assert torch.equal(got[ids == 0], y[ids == 0]), "base tokens must be untouched"
    assert not torch.equal(got[ids == 1], y[ids == 1])


def test_engine_dummy_loras_route_and_reject():
    """tests/test_lora.py::test_engine_dummy_loras_route_and_reject on the
    port's engine: adapters route by name and change the output, an unknown
    adapter is rejected at submit."""
    mc = LlamaModelConfig(num_layers=2, num_q_heads=4, num_kv_heads=2,
                          hidden_size=64, head_dim=16, ffn_inter_dim=128,
                          vocab_size=256, max_position_embeddings=2048,
                          rms_norm_eps=1e-5)
    ec = EngineConfig(model_path="", use_dummy=True, block_size=16,
                      num_hbm_blocks=64, num_cpu_blocks=64,
                      max_blocks_per_seq=16, max_batch_size=8,
                      max_tokens_in_batch=128, prefill_chunk_size=32,
                      max_seqs_in_block_table=32, lora_paths="dummy:x,y,r=4")

    async def body():
        engine = Engine(ec, mc, device="cpu")
        await engine.initialize(tokenizer_backend="inline")
        assert engine.model.lora_slots == {"x": 1, "y": 2}
        loops = asyncio.create_task(engine.start_all_event_loops())
        try:
            outs = await asyncio.wait_for(asyncio.gather(*[
                engine.add_request_and_wait(
                    RawRequest("", 6, prompt_token_ids=list(range(12)), lora=name))
                for name in (None, "x", "y")]), 120)
        finally:
            loops.cancel()
        req = engine.submit(RawRequest("", 4, prompt_token_ids=[1, 2, 3],
                                       lora="nope"))
        return [t for _, t in outs], req
    toks, req = asyncio.run(body())
    assert all(len(t) == 6 for t in toks)
    assert toks[0] != toks[1], "adapter x should perturb the output"
    assert req.aborted


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_make_dummy_loras_byte_equal_to_jax(dtype):
    from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
    from swiftllm_tpu.worker.lora import make_dummy_loras as jax_dummy
    from swiftllm_tpu_torch.worker.lora import make_dummy_loras
    kw = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
              head_dim=16, ffn_inter_dim=128, vocab_size=256,
              max_position_embeddings=2048, rms_norm_eps=1e-5)
    got = make_dummy_loras(["x", "y"], LlamaModelConfig(**kw), 2, dtype, r=4)
    want = jax_dummy(["x", "y"], JaxModelConfig(**kw), 2, dtype, r=4)
    assert got[2:] == want[2:]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].keys() == want[0].keys()
    for k in want[0]:
        for half in ("A", "B"):
            assert got[0][k][half].dtype == want[0][k][half].dtype
            assert got[0][k][half].tobytes() == want[0][k][half].tobytes()


def test_qwen2_config_parses(tiny_qwen2):  # noqa: F811
    mc = LlamaModelConfig.load_from_model_path(tiny_qwen2[0])
    assert mc.qkv_bias and mc.tie_word_embeddings


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_qwen2_greedy_tokens_match_hf(tiny_qwen2, use_pallas):  # noqa: F811
    path, hf_model = tiny_qwen2
    ours = run_port(make_port_model(path, use_pallas), QWEN_PROMPTS, 8)
    for p, o in zip(QWEN_PROMPTS, ours):
        assert o == hf_greedy(hf_model, p, 8), f"prompt {p}: {o}"


def test_qwen2_prefill_logits_match_hf(tiny_qwen2):  # noqa: F811
    path, hf_model = tiny_qwen2
    m = make_port_model(path, True)
    p = QWEN_PROMPTS[0]
    r = Request(RawRequest("", 1))
    r.set_prompt_token_ids(list(p))
    r.seq_id = 0
    _, _, logits = m.forward([ScheduledSeq(r, len(p))], return_logits=True)
    with torch.no_grad():
        hf_logits = hf_model(torch.tensor([p])).logits[0, -1].numpy()
    np.testing.assert_allclose(logits[0][: len(hf_logits)], hf_logits,
                               atol=2e-4, rtol=2e-3)
