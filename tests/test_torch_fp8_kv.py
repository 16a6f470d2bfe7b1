"""The fp8 KV cache in the port against the JAX package's, on the CPU.

The cache layout is the JAX package's byte for byte: rows of e4m3
``[K_all ‖ V_all ‖ 128 scale lanes]``, lane 2*KH the token's K scale and lane
2*KH+1 its V scale (powers of two). fp8 arrays cross between the two packages
as bytes (``fp8_to_torch`` / ``fp8_to_numpy`` of
tests/test_torch_paged_attention.py).

- ``fp8_scales``: equal to the JAX function over a sweep with 0, 1e-20, the
  clip ends, 224 * 2^k and random values. One documented difference: where
  x_max lies a few float32 ulps ABOVE 224 * 2^k, the reference's float32
  ``log2`` rounds up across an integer and its scale is twice the port's
  exact floor; the test pins that (nowhere else, never another factor).
- ``quantize_kv``: the bytes of the JAX package's quantizing ``kv_new`` build
  (``swiftllm_tpu/models/llama.py``, ``fp8_scaled``) for the same k and v,
  from the plain version and from the fused kernel's wrapper
  (``ops/layer_ops.py:rope_qkv_fp8``, its plain version on CPU tensors) at
  position 0, where RoPE leaves k as it is.
- ``rope_qkv_fp8``: the fused row build's bytes against the JAX package's
  biased projections, ``apply_rope`` with ``rope_tables`` and the
  quantizing build, in bf16 (as on the card), head_dim 64 and 128, with
  and without Qwen2's biases.
- The kernels' plain versions against the JAX Pallas kernels in interpret
  mode on the SAME stored bytes, with and without a window: outputs within
  atol 1e-4 / rtol 1e-3 (the JAX file's own fp8 tolerance: f32 on both sides,
  scales folded in at different points), caches byte-equal after the writes.
- One step of ``forward_shard``, both paths, for fp8 and for fp8 with a
  window: logits within atol 1e-4 / rtol 1e-4, greedy tokens equal, cache
  bytes equal. (Both sides compute K and V in f32 in another summation
  order; a value that lands within an ulp of an e4m3 rounding tie could flip
  one byte. These seeds produce none, so the comparison is exact.)
- The ports of tests/test_fp8_kv.py: the cache dtype and size, cosine > 0.98
  against the unquantized cache with dummy weights, cosine > 0.995 and equal
  greedy tokens on a tiny HF checkpoint, and the port's logits against the
  JAX package's on that checkpoint (atol 2e-4 / rtol 2e-3).
- The engine on the CPU with ``kv_quant="fp8"``, and with a window too:
  tokens equal to the JAX engine's.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
from swiftllm_tpu.models.llama import FP8_SCALE_LANES as JAX_SCALE_LANES
from swiftllm_tpu.models.llama import fp8_scales as jax_fp8_scales
from swiftllm_tpu.server.engine import Engine as JaxEngine
from swiftllm_tpu.server.scheduler import ScheduledSeq as JaxScheduledSeq
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu.server.structs import Request as JaxRequest
from swiftllm_tpu.worker.model import LlamaModel as JaxLlamaModel
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu.models import llama as jl
from swiftllm_tpu_torch.models.llama import (FP8_SCALE_LANES, fp8_scales,
                                             quantize_kv_plain, rope_tables)
from swiftllm_tpu_torch.ops import layer_ops as lo
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy
from tests.test_torch_engine import serve
from tests.test_torch_llama import scaled_params
from tests.test_torch_paged_attention import (assert_match, fp8_to_numpy,
                                              fp8_to_torch, make_case, run_jax,
                                              run_torch)

F8 = ml_dtypes.float8_e4m3fn


# --- fp8_scales ------------------------------------------------------------------

def _ulps_above(x: np.ndarray, base: np.ndarray) -> np.ndarray:
    """How many float32 values x lies above base (same binade assumed)."""
    return ((x.view(np.int32) - base.view(np.int32))).astype(np.int64)


def _sweep(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "specials":
        return np.array([0.0, 1e-30, 1e-20, 1e-10, 224.0 * 2.0**-8, 224.0 * 2.0**-9,
                         0.4375, 224.0, 448.0, 224.0 * 2.0**9, 224.0 * 2.0**10,
                         1e6, 3e38], np.float32)
    if kind == "boundaries":
        xs = []
        for k in range(-12, 13):
            b = np.float32(224.0 * 2.0**k)
            lo = hi = b
            xs.append(b)
            for _ in range(12):
                lo = np.nextafter(lo, np.float32(0))
                hi = np.nextafter(hi, np.float32(np.inf))
                xs += [lo, hi]
        return np.array(xs, np.float32)
    return np.exp(rng.uniform(-30, 15, 200_000)).astype(np.float32)


@pytest.mark.parametrize("kind", ["specials", "boundaries", "random"])
def test_fp8_scales_match_jax(kind):
    xs = _sweep(kind)
    want = np.asarray(jax_fp8_scales(jnp.asarray(xs)))
    got = fp8_scales(torch.from_numpy(xs)).numpy()
    # The one difference (see the module docstring): x up to 8 ulps above
    # 224 * 2^k, the reference's scale exactly twice the port's.
    base = (224.0 * np.exp2(np.floor(np.log2(np.maximum(xs, 1e-30).astype(np.float64)
                                             / 224.0)))).astype(np.float32)
    above = _ulps_above(xs, base)
    near = (above > 0) & (above <= 8) & (xs > 1e-20)
    np.testing.assert_array_equal(got[~near], want[~near])
    differs = got != want
    assert np.all(want[differs] == 2 * got[differs])
    # Every scale is a power of two that e4m3 holds exactly, and keeps the
    # scaled value within e4m3's range.
    assert np.array_equal(got.astype(F8).astype(np.float32), got)
    in_range = (xs >= 224.0 * 2.0**-8) & (xs <= 224.0 * 2.0**9)
    assert np.all((xs * got)[in_range] <= 224.0)
    assert np.all((xs * got)[in_range] > 112.0)
    if kind == "boundaries":
        assert differs.any(), "the documented difference no longer occurs"


# --- the quantized kv_new ----------------------------------------------------------

def jax_quantize_kv(kf, vf):
    """The JAX package's quantizing kv_new build (forward_shard, fp8_scaled),
    on its own: it is inline there."""
    kf, vf = jnp.asarray(kf), jnp.asarray(vf)
    ks = jax_fp8_scales(jnp.max(jnp.abs(kf.astype(jnp.float32)), axis=1, keepdims=True))
    vs = jax_fp8_scales(jnp.max(jnp.abs(vf.astype(jnp.float32)), axis=1, keepdims=True))
    lane = jnp.arange(JAX_SCALE_LANES, dtype=jnp.int32)[None, :]
    scale_lanes = jnp.where(lane == 0, ks, jnp.where(lane == 1, vs, 0.0))
    kv_new = jnp.concatenate(
        [jnp.clip(kf.astype(jnp.float32) * ks, -448.0, 448.0),
         jnp.clip(vf.astype(jnp.float32) * vs, -448.0, 448.0), scale_lanes], axis=1)
    return np.asarray(kv_new.astype(jnp.float8_e4m3fn))


MAGNITUDES = {"tiny": 1e-4, "unit": 1.0, "large": 3e4, "past_the_clip": 1e7}


@pytest.mark.parametrize(
    "magnitude,build", [(m, "plain") for m in MAGNITUDES.values()]
    + [(m, "wrapper") for m in MAGNITUDES.values()],
    ids=list(MAGNITUDES) + [f"wrapper_{k}" for k in MAGNITUDES])
def test_quantize_kv_bytes_match_jax(magnitude, build):
    """Rows of very different magnitudes (dummy weights give K/V near 1e-4;
    1e7 is past the lowest scale, where the clip to +-448 acts), one all-zero
    row, one row with a single outlier; from ``models.llama.quantize_kv_plain``
    (the plain version) and from the fused kernel's wrapper
    (``rope_qkv_fp8``, one head of 96 lanes) at position 0, where cos is 1
    and sin 0, so the row is the build of k and v themselves."""
    rng = np.random.default_rng(3)
    k = (rng.normal(size=(64, 96)) * magnitude).astype(np.float32)
    v = (rng.normal(size=(64, 96)) * magnitude * 3).astype(np.float32)
    k[5] = 0.0
    v[7, 11] = 1000.0 * magnitude
    assert FP8_SCALE_LANES == JAX_SCALE_LANES == 128
    if build == "plain":
        got = quantize_kv_plain(torch.from_numpy(k), torch.from_numpy(v))
    else:
        T, KH = k.shape
        tables = rope_tables(torch.zeros(T, dtype=torch.int32),
                             torch.ones(KH // 2), torch.float32)
        _, got = lo.rope_qkv_fp8(torch.zeros(T, KH), torch.from_numpy(k),
                                 torch.from_numpy(v), tables)
    assert got.dtype == torch.float8_e4m3fn and got.shape == (64, 2 * 96 + 128)
    want = jax_quantize_kv(k, v)
    np.testing.assert_array_equal(fp8_to_numpy(got).view(np.uint8),
                                  want.view(np.uint8))
    assert not np.isnan(want.astype(np.float32)).any()
    # The way there and back keeps the bytes.
    assert torch.equal(fp8_to_torch(want).view(torch.uint8), got.view(torch.uint8))


@pytest.mark.parametrize("magnitude", list(MAGNITUDES.values()),
                         ids=list(MAGNITUDES))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_rope_qkv_fp8_bytes_match_jax(bias, hd, magnitude):
    """The fused wrapper's (q_rot, fp8 row) on the CPU against the JAX
    package's ``biased``, ``apply_rope`` with ``rope_tables`` and its
    quantizing ``kv_new`` build (jax_quantize_kv), in bf16 as on the card:
    q_rot bit-equal, the row byte-equal. Rows of the four magnitudes, with
    k's row 5 all zero after its bias add (k = -bk there) and v's row 7 an
    outlier."""
    rng = np.random.default_rng(11)
    T, n_q, n_kv = 16, 4, 2
    QH, KH = n_q * hd, n_kv * hd
    positions = rng.integers(0, 32768, T).astype(np.int32)
    inv_freq = (1.0 / 500000.0 ** (np.arange(0, hd, 2) / hd)).astype(np.float32)
    bf = ml_dtypes.bfloat16

    def draw(*shape, scale=1.0):
        return (rng.normal(size=shape) * magnitude * scale).astype(bf)
    q, k, v = draw(T, QH), draw(T, KH), draw(T, KH, scale=3)
    b = (draw(QH, scale=0.5), draw(KH, scale=0.5), draw(KH, scale=0.5)) if bias else None
    k[5] = -b[1] if bias else 0
    v[7, 11] = 1000.0 * magnitude

    def tt(x):
        return torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    tables = rope_tables(torch.from_numpy(positions), torch.from_numpy(inv_freq),
                         torch.bfloat16)
    got_q, got = lo.rope_qkv_fp8(tt(q), tt(k), tt(v), tables,
                                 tuple(map(tt, b)) if bias else None)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    if bias:   # layer_step's ``biased``
        jq, jk, jv = (y + jnp.asarray(c)[None, :] for y, c in zip((jq, jk, jv), b))
    jt = jl.rope_tables(jnp.asarray(positions), jnp.asarray(inv_freq), jnp.bfloat16)
    want_q = jl.apply_rope(jq.reshape(T, n_q, hd), None, None, tables=jt)
    want_k = jl.apply_rope(jk.reshape(T, n_kv, hd), None, None, tables=jt)
    want = jax_quantize_kv(want_k.reshape(T, KH), jv)
    assert np.abs(np.asarray(want_k.reshape(T, KH)[5], np.float32)).max() == 0
    assert got.dtype == torch.float8_e4m3fn and got.shape == (T, 2 * KH + 128)
    np.testing.assert_array_equal(
        got_q.view(torch.int16).numpy(),
        np.asarray(want_q.reshape(T, QH)).view(np.int16))
    np.testing.assert_array_equal(fp8_to_numpy(got).view(np.uint8),
                                  want.view(np.uint8))
    assert not np.isnan(want.astype(np.float32)).any()


# --- the kernels' plain versions on the same stored bytes -----------------------------

def fp8_case(case):
    """The f32 case with its cache and kv_new quantized (by the port) to fp8
    rows with scale lanes; both packages then read the same bytes. Layers 0
    and 2 are zero bytes (never-written slots, scale 0)."""
    KH = case["kv_new"].shape[1] // 2

    def q(rows):
        t = torch.from_numpy(rows)
        return fp8_to_numpy(quantize_kv_plain(t[:, :KH], t[:, KH:]))

    layer = q(case["cache"][1])
    zeros = np.zeros_like(layer)
    return dict(case, cache=np.stack([zeros, layer, zeros]), kv_new=q(case["kv_new"]))


# name -> (rows (q_len, seq_len), make_case keywords, window)
FP8_CASES = {
    "decode": ([(1, 9), (1, 33), (1, 64), (1, 1)], {}, 0),
    "mixed": ([(1, 17), (5, 29)], {}, 0),
    "mixed_spans": ([(1, 33), (1, 7), (16, 16), (5, 29)], {}, 0),
    "decode_window": ([(1, 100), (1, 77), (1, 3)], dict(Pg=16), 50),
    "mixed_window": ([(1, 60), (1, 5), (32, 32), (21, 77)],
                     dict(Pg=16, q_bucket=32), 5),
}


@pytest.mark.parametrize("name", list(FP8_CASES))
def test_fp8_matches_pallas_interpret(name, monkeypatch):
    specs, kw, window = FP8_CASES[name]
    case = fp8_case(make_case(np.random.default_rng(11), specs, **kw))
    want = run_jax(case, True, monkeypatch, window)
    assert_match(case, run_torch(case, True, window), want, atol=1e-4, rtol=1e-3)
    assert_match(case, run_torch(case, False, window),
                 run_jax(case, False, monkeypatch, window), atol=1e-4, rtol=1e-3)
    # The write happened, and in fp8 bytes.
    assert want[1].dtype == F8
    assert not np.array_equal(want[1].view(np.uint8), case["cache"].view(np.uint8))


def test_fp8_cache_needs_its_scale_lanes():
    """An fp8 cache without the scale tile, or a wider cache that is not
    fp8, is refused by every entry (n_kv no longer follows from the lanes)."""
    from swiftllm_tpu_torch.ops import paged_attention as pa
    case = fp8_case(make_case(np.random.default_rng(2), [(1, 9), (4, 12)]))
    cache = fp8_to_torch(case["cache"])
    kv_new = fp8_to_torch(case["kv_new"])
    t = {k: torch.from_numpy(case[k]) for k in
         ("q", "page_table", "q_starts", "q_lens", "seq_lens", "kv_slots")}
    kw = dict(page_size=case["page_size"], sm_scale=case["sm_scale"])
    for bad in (cache[:, :, :-128].contiguous(), cache.float()):
        with pytest.raises(ValueError, match="cache lanes"):
            pa.paged_decode_attention(t["q"], bad, kv_new, t["page_table"],
                                      t["q_lens"], t["seq_lens"], t["kv_slots"],
                                      1, n_kv=case["n_kv"], **kw)
        with pytest.raises(ValueError, match="cache lanes"):
            pa.paged_prefill_attention(t["q"], bad, t["page_table"],
                                       t["q_starts"], t["q_lens"], t["seq_lens"],
                                       1, n_kv=case["n_kv"], q_bucket=4, **kw)


# --- one step of forward_shard ----------------------------------------------------------

@dataclasses.dataclass
class StepCase:
    """A SARATHI mixed step (two decode rows, one of which reads its token
    from the feedback buffer, a chunk that starts mid-sequence, and a fresh
    prompt) through the JAX model and the port's on the same parameters,
    cache bytes and feedback buffer. Head shapes (4 q heads of 32 over 2 kv
    heads) are ones the Pallas kernels take, so ``use_pallas=True`` runs them
    (interpret mode) on the JAX side. There the rows go through as two steps,
    the prefill-kind rows and then the decode rows: the JAX model's MIXED
    step through its Pallas kernels gives NaN on the decode rows in interpret
    mode on the CPU backend (with or without fp8 or a window), so the mixed
    step through the Pallas kernels is held at the attention level, by the
    ``*_matches_pallas_interpret`` tests."""

    window: int
    kv_quant: str
    # (prompt_len, cached, outputs, n_tokens) per row; decode rows first.
    rows = [(45, 45, [5], 1), (13, 14, [7, None], 1), (80, 32, [], 32),
            (20, 0, [], 20)]

    def configs(self, use_pallas):
        mc = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=128,
                  head_dim=32, ffn_inter_dim=128, vocab_size=128,
                  max_position_embeddings=512, rms_norm_eps=1e-5,
                  sliding_window=self.window or None)
        ec = dict(model_path="", use_dummy=True, dtype="float32", block_size=32,
                  num_hbm_blocks=16, max_blocks_per_seq=4, max_batch_size=4,
                  max_tokens_in_batch=128, prefill_chunk_size=32,
                  max_seqs_in_block_table=8, preemption_mode="recompute",
                  kv_quant=self.kv_quant, use_pallas=use_pallas)
        return mc, ec

    def schedule(self, Req, Raw, Sched, mgr):
        """Every row as a scheduled sequence, its cached pages allocated."""
        out = []
        for i, (plen, cached, outputs, n) in enumerate(self.rows):
            r = Req(Raw("", 4))
            r.set_prompt_token_ids([(5 * i + j) % 120 + 1 for j in range(plen)])
            r.output_token_ids = list(outputs)
            r.num_cached_tokens = cached
            r.seq_id = i + 1
            if cached:
                mgr.allocate_for_seq(i + 1, cached)
            out.append(Sched(r, n))
        return out

    @staticmethod
    def run_steps(model, sched, steps):
        """[(tokens, logits) of the live rows] for each step's subset of rows."""
        out = []
        for rows in steps:
            tokens, live, logits = model.forward([sched[i] for i in rows],
                                                 return_logits=True)
            live = np.array([r is not None for r in live])
            assert live.sum() == len(rows)
            out.append((tokens[live], logits[live]))
        return out

    def check(self, use_pallas, monkeypatch):
        monkeypatch.setenv("SWIFTLLM_PALLAS_INTERPRET", "1")
        rng = np.random.default_rng(0)
        mc, ec = self.configs(use_pallas)
        jm = JaxLlamaModel(JaxEngineConfig(**ec), JaxModelConfig(**mc))
        jm.load_weights()
        jm.init_kvcache_and_swap()
        tree = scaled_params(jm.params, rng)
        jm.params = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                                 jm.params, tree)
        L, S, W = jm.kv_cache.shape
        fp8 = self.kv_quant == "fp8"
        if fp8:
            assert jm.kv_cache.dtype == jnp.float8_e4m3fn
            KH = (W - 128) // 2
            kv = torch.from_numpy(rng.normal(size=(L * S, 2 * KH)).astype(np.float32))
            cache = fp8_to_numpy(quantize_kv_plain(kv[:, :KH], kv[:, KH:])).reshape(L, S, W)
        else:
            cache = rng.normal(size=(L, S, W)).astype(np.float32)
        feedback = rng.integers(0, 128, size=jm.token_feedback.shape).astype(np.int32)
        jm.kv_cache = jax.device_put(cache, jm.kv_cache.sharding)
        jm.token_feedback = jax.device_put(feedback, jm.token_feedback.sharding)
        steps = [[2, 3], [0, 1]] if use_pallas else [[0, 1, 2, 3]]
        want = self.run_steps(jm, self.schedule(
            JaxRequest, JaxRawRequest, JaxScheduledSeq, jm.hbm_block_mgrs[0]), steps)

        m = LlamaModel(EngineConfig(**ec), LlamaModelConfig(**mc), device="cpu")
        m.params = params_from_numpy(tree, "cpu")
        m.init_kvcache_and_swap()
        assert tuple(m.kv_cache.shape) == (L, S, W)
        m.kv_cache.copy_(fp8_to_torch(cache) if fp8 else torch.from_numpy(cache))
        m.token_feedback.copy_(torch.from_numpy(feedback))
        got = self.run_steps(m, self.schedule(
            Request, RawRequest, ScheduledSeq, m.hbm_block_mgrs[0]), steps)
        for (tokens, logits), (want_tokens, want_logits) in zip(got, want):
            assert np.isfinite(want_logits).all()
            np.testing.assert_allclose(logits, want_logits, atol=1e-4, rtol=1e-4)
            np.testing.assert_array_equal(tokens, want_tokens)
        np.testing.assert_array_equal(m.token_feedback.numpy()[:-1],
                                      np.asarray(jm.token_feedback)[:-1])
        ps = ec["block_size"]
        after = np.asarray(jm.kv_cache)
        if fp8:
            got = fp8_to_numpy(m.kv_cache).view(np.uint8)
            np.testing.assert_array_equal(got[:, :-ps], after.view(np.uint8)[:, :-ps])
            assert not np.array_equal(got[:, :-ps], cache.view(np.uint8)[:, :-ps])
        else:
            np.testing.assert_allclose(m.kv_cache.numpy()[:, :-ps], after[:, :-ps],
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("window", [0, 12], ids=["full", "window12"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["gather_reference", "kernels"])
def test_fp8_step_matches_jax(use_pallas, window, monkeypatch):
    StepCase(window=window, kv_quant="fp8").check(use_pallas, monkeypatch)


# --- the ports of tests/test_fp8_kv.py -------------------------------------------------

def _drive(model, Req, Raw, Sched, prompt, n_decode):
    """Prefill the prompt, then n_decode greedy steps; the logits of every
    step and the decoded tokens."""
    r = Req(Raw("", n_decode + 1))
    r.set_prompt_token_ids(list(prompt))
    r.seq_id = 0
    _, _, logits = model.forward([Sched(r, len(prompt))], return_logits=True)
    outs, toks = [logits[0]], []
    r.output_token_ids.append(int(np.argmax(logits[0])))
    r.num_cached_tokens += len(prompt)
    for _ in range(n_decode):
        tokens, _, logits = model.forward([Sched(r, 1)], return_logits=True)
        outs.append(logits[0])
        toks.append(int(tokens[0]))
        r.output_token_ids.append(int(tokens[0]))
        r.num_cached_tokens += 1
    return np.stack(outs), toks


FP8_EC = dict(model_path="", dtype="float32", block_size=32, num_hbm_blocks=32,
              max_blocks_per_seq=8, max_tokens_in_batch=64, prefill_chunk_size=32,
              max_seqs_in_block_table=16, preemption_mode="recompute")
DUMMY_MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
                head_dim=16, ffn_inter_dim=128, vocab_size=128,
                max_position_embeddings=2048, rms_norm_eps=1e-5)
PROMPT = [(i * 13) % 128 for i in range(20)]


def _port_dummy(kv_quant, use_pallas):
    m = LlamaModel(EngineConfig(**dict(FP8_EC, use_dummy=True, kv_quant=kv_quant,
                                       use_pallas=use_pallas)),
                   LlamaModelConfig(**DUMMY_MC), device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    return m


def _cosines(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_fp8_cache_dtype_and_size():
    """fp8 is a quarter of f32's bytes per lane, plus one 128-lane scale tile
    next to the 2*n_kv*hd = 64 data lanes; the pool is sized from that row."""
    m, base = _port_dummy("fp8", False), _port_dummy("none", False)
    assert m.kv_cache.dtype == torch.float8_e4m3fn and m.kv_dtype == m.kv_cache.dtype
    lanes_fp8, lanes_f32 = m.kv_cache.shape[2], base.kv_cache.shape[2]
    assert lanes_fp8 == lanes_f32 + 128
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    assert nbytes(m.kv_cache) * 4 == nbytes(base.kv_cache) * lanes_fp8 // lanes_f32
    # profile_num_blocks on the CPU: a 1 GB budget over the page's bytes.
    ec = dict(FP8_EC, use_dummy=True, num_hbm_blocks=None)
    pages = {q: LlamaModel(EngineConfig(**dict(ec, kv_quant=q)),
                           LlamaModelConfig(**DUMMY_MC), device="cpu"
                           ).profile_num_blocks() for q in ("none", "fp8")}
    assert pages["fp8"] == 2**30 // (2 * (64 + 128) * 1 * 32)
    assert pages["none"] == 2**30 // (2 * 64 * 4 * 32)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_fp8_logits_close_to_full_precision(use_pallas):
    """Dummy weights give K/V near 1e-4, far below e4m3's subnormal floor:
    the per-token scales must bring them into range by themselves."""
    args = (Request, RawRequest, ScheduledSeq, PROMPT, 4)
    base, _ = _drive(_port_dummy("none", use_pallas), *args)
    fp8, _ = _drive(_port_dummy("fp8", use_pallas), *args)
    cos = _cosines(base, fp8)
    assert np.all(cos > 0.98), cos


def test_fp8_requires_32_aligned_pages():
    with pytest.raises(AssertionError):
        EngineConfig(model_path="", kv_quant="fp8", block_size=16)


@pytest.fixture(scope="module")
def fp8_ckpt(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM
    path = tmp_path_factory.mktemp("fp8_llama")
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      rms_norm_eps=1e-5, tie_word_embeddings=False)
    torch.manual_seed(7)
    LlamaForCausalLM(cfg).eval().save_pretrained(str(path), safe_serialization=True)
    return str(path)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_fp8_real_checkpoint_accuracy(fp8_ckpt, use_pallas):
    """Per-token-scale fp8 KV on a tiny random-init HF checkpoint: logits
    close to the full-precision cache's and the same greedy tokens; and the
    port's fp8 logits against the JAX package's on the same checkpoint."""
    prompt = [(i * 13) % 128 for i in range(24)]

    def run(kv_quant):
        m = LlamaModel(EngineConfig(**dict(FP8_EC, model_path=fp8_ckpt,
                                           kv_quant=kv_quant, use_pallas=use_pallas)),
                       device="cpu")
        m.load_weights()
        m.init_kvcache_and_swap()
        return _drive(m, Request, RawRequest, ScheduledSeq, prompt, 3)

    (base, base_toks), (fp8, fp8_toks) = run("none"), run("fp8")
    assert np.all(_cosines(base, fp8) > 0.995)
    assert np.array_equal(base.argmax(-1), fp8.argmax(-1)) and base_toks == fp8_toks

    jm = JaxLlamaModel(JaxEngineConfig(**dict(
        FP8_EC, model_path=fp8_ckpt, kv_quant="fp8", use_pallas=False,
        num_cpu_blocks=0)))
    jm.load_weights()
    jm.init_kvcache_and_swap()
    want, want_toks = _drive(jm, JaxRequest, JaxRawRequest, JaxScheduledSeq, prompt, 3)
    np.testing.assert_allclose(fp8, want, atol=2e-4, rtol=2e-3)
    assert fp8_toks == want_toks


# --- the engine ---------------------------------------------------------------------

ENGINE_MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
                 head_dim=16, ffn_inter_dim=128, vocab_size=256,
                 max_position_embeddings=2048, rms_norm_eps=1e-5)
ENGINE_EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=32,
                 num_hbm_blocks=32, max_blocks_per_seq=8, max_batch_size=8,
                 max_tokens_in_batch=128, prefill_chunk_size=32,
                 max_seqs_in_block_table=32, preemption_mode="recompute",
                 use_pallas=False)


def engine_tokens_both(mc_kw, ec_kw, use_pallas):
    """Five requests (one longer than the chunk) through the JAX engine and
    the port's engine on the same scaled dummy parameters. Returns (JAX
    tokens, port tokens, the port's free pages before and after)."""
    mc, ec = dict(ENGINE_MC, **mc_kw), dict(ENGINE_EC, **ec_kw)

    async def body():
        je = JaxEngine(JaxEngineConfig(**ec), JaxModelConfig(**mc))
        await je.initialize(tokenizer_backend="inline")
        tree = scaled_params(je.model.params, np.random.default_rng(1))
        je.model.params = jax.tree.map(
            lambda old, new: jax.device_put(new, old.sharding), je.model.params, tree)
        want = await serve(je, JaxRawRequest)
        e = Engine(EngineConfig(**dict(ec, use_pallas=use_pallas)),
                   LlamaModelConfig(**mc), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        e.model.params = params_from_numpy(tree, "cpu")
        mgr = e.model.hbm_block_mgrs[0]
        free0 = mgr.num_free_blocks
        got = await serve(e, RawRequest)
        return want, got, free0, mgr.num_free_blocks
    return asyncio.run(body())


@pytest.mark.parametrize("window", [None, 7], ids=["full", "window7"])
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_engine_fp8_tokens_match_jax(use_pallas, window):
    want, got, free0, free1 = engine_tokens_both(
        dict(sliding_window=window), dict(kv_quant="fp8"), use_pallas)
    assert got == want
    assert all(len(t) == 6 for t in got)
    assert free1 == free0 == ENGINE_EC["num_hbm_blocks"]
