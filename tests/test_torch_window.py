"""Sliding-window attention in the port against the JAX package's, on the CPU.

- The kernels' plain versions (what the wrappers of
  ``swiftllm_tpu_torch.ops.paged_attention`` run on CPU tensors, and what the
  card holds the CUDA kernels against) against the JAX Pallas kernels in
  interpret mode and the JAX gather reference, on the cases of the JAX
  package's own window tests: a decode whose early chunks are wholly masked,
  a window boundary in the middle of a chunk, windowed prefill and mixed
  steps, spans of several tiles, and a window wider than every history.
- One step of ``forward_shard`` with a windowed model, both paths.
- A tiny Mistral checkpoint with ``sliding_window=5`` (shorter than the
  prompts), built locally: greedy tokens equal to HF's and the JAX package's,
  with whole and chunked prefill.
- The engine on the CPU with a windowed model: tokens equal to the JAX
  engine's.

Tolerances: attention outputs within f32 atol 2e-5 / rtol 1e-4 (f32 on both
sides, only the summation order differs), caches exactly equal; a step's
logits within atol 1e-4 / rtol 1e-4; greedy tokens exactly.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

from tests.test_llama_golden import hf_greedy, make_model, run_ours
from tests.test_qwen2_golden import SWA_PROMPTS, tiny_mistral_swa  # noqa: F401
from tests.test_torch_fp8_kv import ENGINE_EC, StepCase, engine_tokens_both
from tests.test_torch_model import make_port_model, run_port
from tests.test_torch_paged_attention import (assert_match, make_case, run_jax,
                                              run_torch)

# name -> (rows (q_len, seq_len), make_case keywords, window)
CASES = {
    "decode_fully_masked_chunks":
        ([(1, 512), (1, 300), (1, 40), (1, 1)], dict(Pg=64), 64),
    "decode_boundary_mid_chunk": ([(1, 100), (1, 77), (1, 64)], dict(Pg=16), 50),
    "decode_window_below_page": ([(1, 100), (1, 9), (1, 3)], dict(Pg=16), 3),
    "decode_window_one": ([(1, 20), (1, 1)], {}, 1),
    "prefill_and_mixed": ([(1, 33), (16, 16), (8, 40)], {}, 8),
    "fused_span_prefill": ([(64, 64), (33, 89)], dict(Pg=16, q_bucket=64), 24),
    "mixed_windows_start_inside_tile":
        ([(1, 60), (1, 5), (32, 32), (21, 77)], dict(Pg=16, q_bucket=32), 5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_window_matches_pallas_interpret(name, monkeypatch):
    """The kernels' plain versions against the JAX Pallas kernels (interpret
    mode), and the port's gather reference against the JAX one."""
    specs, kw, window = CASES[name]
    # 64-key chunks on the JAX side, so that the long rows span several.
    monkeypatch.setenv("SWIFTLLM_DECODE_CHUNK", "64")
    case = make_case(np.random.default_rng(40 + list(CASES).index(name)),
                     specs, **kw)
    assert_match(case, run_torch(case, True, window),
                 run_jax(case, True, monkeypatch, window))
    assert_match(case, run_torch(case, False, window),
                 run_jax(case, False, monkeypatch, window))


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_window_wider_than_history_matches_full(use_kernels):
    """A window that no history reaches gives exactly the unwindowed result."""
    case = make_case(np.random.default_rng(42), [(1, 17), (4, 29)])
    full, _ = run_torch(case, use_kernels)
    wide, _ = run_torch(case, use_kernels, window=4096)
    np.testing.assert_array_equal(full, wide)
    narrow, _ = run_torch(case, use_kernels, window=3)
    assert not np.array_equal(full, narrow)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["gather_reference", "kernels"])
def test_window_step_matches_jax(use_pallas, monkeypatch):
    """One mixed step of forward_shard with a window of 12 (shorter than two
    rows' histories): logits, greedy tokens and the written cache."""
    StepCase(window=12, kv_quant="none").check(use_pallas, monkeypatch)


# --- the tiny Mistral checkpoint, window 5 --------------------------------------

@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_mistral_sliding_window_greedy_matches_hf_and_jax(
        tiny_mistral_swa, mode, use_pallas):  # noqa: F811
    path, hf_model = tiny_mistral_swa
    m = make_port_model(path, use_pallas)
    assert m.model_config.sliding_window == 5
    chunked = mode == "chunked"
    got = run_port(m, SWA_PROMPTS, 6, chunked=chunked, chunk=4)
    assert got == run_ours(make_model(path), SWA_PROMPTS, 6, chunked=chunked,
                           chunk=4)
    for p, o in zip(SWA_PROMPTS, got):
        assert o == hf_greedy(hf_model, p, 6), f"prompt {p}: {o}"


# --- the engine ----------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_engine_window_tokens_match_jax(use_pallas):
    """Window 7, shorter than every prompt but two."""
    want, got, free0, free1 = engine_tokens_both(dict(sliding_window=7), {},
                                                 use_pallas)
    assert got == want
    assert free1 == free0 == ENGINE_EC["num_hbm_blocks"]
