"""Llama-family forward pass for the PyTorch port: one rank's shard.

A port of ``swiftllm_tpu/models/llama.py`` that keeps its names and layouts:

- The step consumes ONE flat token batch, decode tokens and prefill chunks
  mixed (SARATHI), described by a ``StepBatch`` that ``unpack_step_batch``
  rebuilds on the device from the packed i32 buffer of
  ``worker/batch_builder.pack_step_batch``.
- The paged KV cache is ``[L, S, W]``: S flat slots ((pages + 1) * page_size,
  the +1 a garbage page that padding tokens write into) and W = 2*n_kv*hd
  lanes laid out ``[K_all ‖ V_all]``. With ``kv_quant="fp8"`` the cache is
  ``torch.float8_e4m3fn`` and each row ends in ``FP8_SCALE_LANES`` more lanes
  that hold the token's power-of-two K and V scales (``ops/quantize_kv.py``),
  byte for byte the JAX package's layout.
- A Python loop over layers replaces ``lax.scan``. Where JAX donates the
  cache and the feedback buffer to the step, this port updates both IN PLACE.
- Attention goes through the hand-written CUDA kernels of
  ``ops/paged_attention.py`` (``use_kernels``, the config's ``use_pallas``),
  or through ``_ragged_paged_attention_torch``, the port of the JAX package's
  gather-based reference. Projections, the embedding gather and the argmax
  are plain PyTorch, as the JAX package leaves them to XLA. Where XLA fuses
  what plain PyTorch cannot, ``use_kernels`` takes hand-written kernels:
  the layer's elementwise work (``ops/layer_ops.py``: the residual add with
  the next RMSNorm, the bias adds with RoPE and the K‖V row, SiLU·up); every
  quantized weight of every bucket (INT8: ``ops/int8_matmul.py``, INT4:
  ``ops/int4_matmul.py``; above 256 tokens in their wide configuration) and
  a quantized ``lm_head`` at any row count (B, or B·S1 in a verify step);
  an fp8 cache's rows, built in the RoPE kernel's launch
  (``ops/layer_ops.py:rope_qkv_fp8``). Without ``use_kernels``
  everything runs as the kernels' plain versions (``quant.proj`` for the
  quantized weights).
- Multi-LoRA: a projection that an adapter targets adds each token's own
  adapter update (``lora_add``, plain GEMMs, as the JAX package leaves its
  einsums to XLA), in every step kind: mixed, multi-step and verify.
- ``make_step_fn`` is the counterpart of the JAX package's: one step of a
  bucket as a function of (params, cache, feedback, packed batch) that reads
  nothing on the host, so ``worker/graphs.py`` can capture it in a CUDA
  graph and replay it.
- Tensor and data parallelism (``mesh``, ``parallel/mesh.py``): the step
  runs on one rank's shard, as the JAX package's ``forward_shard`` runs
  under ``shard_map``: n_q/tp query heads and n_kv_eff/tp KV heads, the
  vocab-sharded embedding (masked gather, all-reduce), an all-reduce after
  ``wo`` and after ``w_down``, the vocab padding masked out of the logits,
  the head's gathers over tp (``models/sampling.py``), and the sampled
  tokens and logprobs gathered over dp, so every rank returns every dp
  group's. The collectives are ``parallel/distributed.py``'s.

Numerics round where the JAX package rounds: RMSNorm casts back to the
activation dtype BEFORE the weight multiply, SiLU runs in f32 and is cast
back, and the logits are a product in the activation dtype cast to f32.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from swiftllm_tpu_torch.config import LlamaModelConfig
from swiftllm_tpu_torch.models.sampling import (chosen_logprobs, exact_greedy,
                                                sample_tokens)
from swiftllm_tpu_torch.ops import int4_matmul, int8_matmul
from swiftllm_tpu_torch.ops import layer_ops as lo
from swiftllm_tpu_torch.ops import paged_attention as pa
# The plain fp8 row build (tests and chip_smoke.py import it from here);
# forward_shard builds the rows with rope_qkv_fp8.
from swiftllm_tpu_torch.ops.quantize_kv import (  # noqa: F401
    fp8_scales, quantize_kv_plain)
from swiftllm_tpu_torch.parallel.distributed import (all_reduce_tp, gather_dp,
                                                     gather_tp)
from swiftllm_tpu_torch.parallel.mesh import (SINGLE, Mesh,
                                              effective_num_kv_heads)
from swiftllm_tpu_torch.worker.quant import is_quantized, proj


@dataclasses.dataclass
class StepBatch:
    """One step's flat token batch, padded to bucket sizes (T tokens, B rows,
    Pg pages per row). The batch builder fills it with numpy arrays on the
    host; ``unpack_step_batch`` rebuilds it as tensors on the device."""

    token_ids: Any          # i32[T]   flat new tokens (pad 0)
    positions: Any          # i32[T]   position of each token in its sequence
    kv_slots: Any           # i32[T]   cache slot each token's KV goes to
                            #          (pad -> the garbage page)
    q_starts: Any           # i32[B]   first flat token of each row (pad T)
    q_lens: Any             # i32[B]   tokens fed for each row this step
    seq_lens: Any           # i32[B]   KV length of each row AFTER this step
    page_table: Any         # i32[B,P] page ids per row (pad 0)
    sample_mask: Any        # bool[B]  row produces a sampled token
    temperature: Any = 0.0  # f32[B]
    top_p: Any = 1.0        # f32[B]
    top_k: Any = 0          # i32[B]
    seeds: Any = 0          # u32[B] (i32 bits on the device)
    feedback_read: Any = -1   # i32[T] feedback slot to read the token from
    feedback_write: Any = 0   # i32[B] feedback slot for row b's sample
    lora_ids: Any = 0         # i32[T]
    decode_row: Any = False   # bool[B] row is decode-kind (n_tokens == 1)
    kv_slots_scatter: Any = 0  # i32[T] real slot for prefill-kind tokens;
                               #        the builder gives decode-kind and pad
                               #        tokens the garbage slot, and
                               #        unpack_step_batch gives them -1,
                               #        which store_kv drops


def unpack_step_batch(flat: torch.Tensor, T: int, B: int, Pg: int, *,
                      page_size: int, garbage_slot: int) -> StepBatch:
    """Inverse of ``worker.batch_builder.pack_step_batch``: slice the packed
    i32 buffer and derive the per-token fields (positions, slots, feedback
    reads, LoRA ids) from the row fields and the page table, on the buffer's
    device. The float fields are bit-casts (``view``), not conversions."""
    off = 0

    def take(n):
        nonlocal off
        out = flat[off:off + n]
        off += n
        return out

    token_ids = take(T)
    q_starts = take(B)
    q_lens = take(B)
    seq_lens = take(B)
    sample_mask = take(B) != 0
    temperature = take(B).view(torch.float32)
    top_p = take(B).view(torch.float32)
    top_k = take(B)
    seeds = take(B)
    feedback_write = take(B)
    decode_row = take(B) != 0
    frd_row = take(B)
    lora_row = take(B)
    page_table = take(B * Pg).view(B, Pg)

    # Row of token t: q_starts ascend (pad rows at T), so the owning row is
    # the last start <= t. Alignment gaps and pad tokens come out invalid.
    t_iota = torch.arange(T, dtype=torch.int32, device=flat.device)
    row = (torch.searchsorted(q_starts, t_iota, right=True) - 1).clamp(0, B - 1)
    start = q_starts[row]
    qlen = q_lens[row]
    o = t_iota - start
    valid = (o >= 0) & (o < qlen)
    pos = torch.where(valid, seq_lens[row] - qlen + o, 0)
    pidx = (pos // page_size).clamp(0, Pg - 1)
    slot = page_table[row, pidx] * page_size + pos % page_size
    kv_slots = torch.where(valid, slot, garbage_slot)
    # Only prefill-kind tokens are scattered (the decode kernel writes its
    # rows' KV itself). The JAX package points the rest at the garbage slot;
    # -1 makes store_kv skip them instead of writing the garbage page.
    kv_slots_scatter = torch.where(valid & ~decode_row[row], slot, -1)
    feedback_read = torch.where(valid & (o == qlen - 1), frd_row[row], -1)
    lora_ids = torch.where(valid, lora_row[row], 0)

    return StepBatch(token_ids=token_ids, positions=pos, kv_slots=kv_slots,
                     q_starts=q_starts, q_lens=q_lens, seq_lens=seq_lens,
                     page_table=page_table, sample_mask=sample_mask,
                     temperature=temperature, top_p=top_p, top_k=top_k,
                     seeds=seeds, feedback_read=feedback_read,
                     feedback_write=feedback_write, decode_row=decode_row,
                     kv_slots_scatter=kv_slots_scatter, lora_ids=lora_ids)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def compute_inv_freq(cfg: LlamaModelConfig) -> np.ndarray:
    """Rotary inverse frequencies with Llama-3 / linear scaling applied
    (HF semantics): "linear" divides by the factor, "llama3" smooths between
    a low and a high frequency band."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    scaling = cfg.rope_scaling
    if scaling is None:
        pass
    elif isinstance(scaling, (int, float)):
        inv_freq = inv_freq / float(scaling)
    elif isinstance(scaling, dict):
        rope_type = scaling.get("rope_type", scaling.get("type", "default"))
        if rope_type == "linear":
            inv_freq = inv_freq / float(scaling["factor"])
        elif rope_type == "llama3":
            factor = float(scaling["factor"])
            low = float(scaling["low_freq_factor"])
            high = float(scaling["high_freq_factor"])
            orig = float(scaling["original_max_position_embeddings"])
            wavelen = 2 * np.pi / inv_freq
            low_wl = orig / low
            high_wl = orig / high
            smooth = (orig / wavelen - low) / (high - low)
            inv_freq = np.where(
                wavelen > low_wl, inv_freq / factor,
                np.where(wavelen < high_wl, inv_freq,
                         (1 - smooth) / factor * inv_freq + smooth * inv_freq))
        elif rope_type != "default":
            raise NotImplementedError(f"rope_scaling type {rope_type!r}")
    return inv_freq.astype(np.float32)


def rope_tables(positions: torch.Tensor, inv_freq: torch.Tensor, dtype):
    """cos/sin [T, 1, hd/2] in ``dtype``, computed once per step (the
    tables ``ops/layer_ops.py:rope_qkv`` reads)."""
    angles = positions.float()[:, None] * inv_freq[None, :]
    return (torch.cos(angles).to(dtype)[:, None, :],
            torch.sin(angles).to(dtype)[:, None, :])


# ---------------------------------------------------------------------------
# fp8 KV: per-token power-of-two scales, kept in the cache row's last lanes
# ---------------------------------------------------------------------------

FP8_SCALE_LANES = pa.FP8_SCALE_LANES


# ---------------------------------------------------------------------------
# Attention over the paged cache: the plain, gather-based path
# ---------------------------------------------------------------------------

def _ragged_paged_attention_torch(q, cache_l, batch: StepBatch, *,
                                  page_size: int, sm_scale: float,
                                  q_bucket: int, window: int = 0):
    """Gather-based attention, the port of the JAX package's
    ``_ragged_paged_attention_jnp``: every row attends over its own paged KV.

    q [T, n_q, hd]; cache_l [S, 2, n_kv, hd] (one layer, true values: an
    fp8 cache comes un-scaled). With ``window`` only the last ``window``
    positions are visible (key_pos in (q_pos - window, q_pos]). It materialises the
    gathered KV of every row ([B, Pg*page_size, ...]), so it serves the CPU
    and ``use_pallas=False``; the kernels implement the same contract."""
    T, n_q, hd = q.shape
    B, Pg = batch.page_table.shape
    S, n_kv = cache_l.shape[0], cache_l.shape[2]
    group = n_q // n_kv
    K = Pg * page_size
    dev = q.device

    slot_ids = (batch.page_table[:, :, None].long() * page_size
                + torch.arange(page_size, device=dev)[None, None, :]
                ).reshape(B, K).clamp(0, S - 1)      # JAX clamps the gather
    kv = cache_l[slot_ids].to(q.dtype)               # [B, K, 2, n_kv, hd]
    k, v = kv[:, :, 0], kv[:, :, 1]

    # Dense query view [B, Q] of flat-token indices (pad -> zero row at T).
    q_iota = torch.arange(q_bucket, device=dev)
    q_tok = torch.where(q_iota[None, :] < batch.q_lens[:, None],
                        batch.q_starts[:, None] + q_iota[None, :],
                        T).clamp(0, T)
    q_pad = torch.cat([q, q.new_zeros(1, n_q, hd)])
    qd = q_pad[q_tok].reshape(B, q_bucket, n_kv, group, hd)
    q_pos = torch.cat([batch.positions,
                       batch.positions.new_zeros(1)])[q_tok]     # [B, Q]

    scores = torch.einsum("bqngd,bknd->bngqk", qd.float(), k.float()) * sm_scale
    key_pos = torch.arange(K, device=dev)
    valid = ((key_pos[None, None, :] <= q_pos[:, :, None])
             & (key_pos[None, None, :] < batch.seq_lens[:, None, None]))
    if window:
        valid &= key_pos[None, None, :] > q_pos[:, :, None] - window
    scores = torch.where(valid[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", probs, v.float())
    out = out.reshape(B, q_bucket, n_q, hd).to(q.dtype)

    o_flat = q.new_zeros(T + 1, n_q, hd)
    o_flat[q_tok] = out
    return o_flat[:T]


# ---------------------------------------------------------------------------
# Multi-LoRA
# ---------------------------------------------------------------------------

def lora_select(lora_ids: torch.Tensor, lora_scale: torch.Tensor) -> torch.Tensor:
    """Per (token, adapter) scale, f32[T, n]: adapter s-1's alpha/r where the
    token's slot is s, else 0 (slot 0, the base model, scales none). Built
    once a step and shared by every projection."""
    slots = torch.arange(1, lora_scale.shape[0] + 1, device=lora_ids.device,
                         dtype=lora_ids.dtype)
    return (lora_ids[:, None] == slots).float() * lora_scale


def lora_add(y: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """y + each token's own adapter update, in place: y[T, out] +=
    sum over adapters n of sel[t, n] * (x[t] @ A[n].T) @ B[n].T, for one
    layer's stacked adapters A [n, r, in], B [n, out, r] and ``sel`` from
    ``lora_select``.

    The JAX package's form (``swiftllm_tpu/models/llama.py``, ``lora_add``
    in ``layer_step``) computes every adapter's update for every token, an
    f32 [T, n, out] intermediate, and selects it by slot with a third
    einsum. This form computes the same function in three launches and no
    [T, n, out] tensor: z = x @ A_stackᵀ ([T, n*r], rounded to x's type as
    the reference rounds it), z scaled per (token, adapter) in place (the
    product in f32, rounded to x's type), then ``y.addmm_(z, B_stackᵀ)``,
    which sums in f32 and rounds once, where the reference rounds the update
    and then the sum. A base token's z row is 0, so its y is left exactly as
    it was. B laid out by ``worker/weights.lora_entry`` makes B_stackᵀ a
    view."""
    n, r, d_in = A.shape
    z = F.linear(x, A.reshape(n * r, d_in))                          # [T, n*r]
    z.view(-1, n, r).mul_(sel[:, :, None])
    return y.addmm_(z, B.transpose(-1, -2).reshape(n * r, -1))


def _attention_and_store(q, kv_new, cache, layer: int, batch: StepBatch, *,
                         n_kv: int, page_size: int, sm_scale: float,
                         use_kernels: bool, q_bucket: int, window: int = 0,
                         kv_pend=None, npend: int = 0,
                         live_rows: int | None = None,
                         bf16_scores: bool | None = None):
    """Store this layer's fresh K‖V (kv_new [T, W], in the cache dtype, with
    the scale lanes when the cache is fp8) into the cache [L, S, W] IN PLACE
    and run attention; returns [T, n_q, hd].

    Deferred commit (``kv_pend`` [L, P, B, W], multi-step windows): the
    decode entry reads the window's ``npend - 1`` completed tokens from
    ``kv_pend`` and this step's from ``kv_new``, and the cache is NOT
    written; ``decode_multi_step`` commits the whole window after its loop.

    Kernels: decode buckets run the decode kernel, which writes its rows' KV
    itself. Mixed buckets keep the JAX order: the decode kernel on the
    decode-kind rows (packed first, flat token == row), then ``store_kv`` of
    the prefill-kind spans and the prefill kernel on them; tokens below
    n_dec take the decode output, the rest the prefill output. The kernels
    plan their key splits over the rows below ``live_rows`` (a host
    integer: rows from it on have no query; None: any row may).
    ``bf16_scores`` picks the prefill kernel's bf16-score variant (None:
    ``SWIFTLLM_TILE_BF16_SCORES``, read at the call)."""
    T, _, hd = q.shape
    kw = dict(n_kv=n_kv, page_size=page_size, sm_scale=sm_scale, window=window)
    kern = dict(kw, live_rows=live_rows)
    if kv_pend is not None:
        assert use_kernels and q_bucket == 1, \
            "deferred KV commit runs on the decode kernel's path only"
        return pa.paged_decode_attention_pend(
            q, cache, kv_new, kv_pend, batch.page_table, batch.q_lens,
            batch.seq_lens, layer, npend=npend, **kern)
    if use_kernels and q_bucket == 1:
        return pa.paged_decode_attention(
            q, cache, kv_new, batch.page_table, batch.q_lens, batch.seq_lens,
            batch.kv_slots, layer, **kern)
    if use_kernels:
        q_lens_dec = torch.where(batch.decode_row, batch.q_lens, 0)
        q_lens_pre = torch.where(batch.decode_row, 0, batch.q_lens)
        dec_out = pa.paged_decode_attention(
            q, cache, kv_new, batch.page_table, q_lens_dec, batch.seq_lens,
            batch.kv_slots, layer, **kern)
        pa.store_kv(cache, kv_new, batch.kv_slots_scatter, layer)
        pre_out = pa.paged_prefill_attention(
            q, cache, batch.page_table, batch.q_starts, q_lens_pre,
            batch.seq_lens, layer, q_bucket=q_bucket, bf16_scores=bf16_scores,
            **kern)
        n_dec = batch.decode_row.sum()
        tok = torch.arange(T, device=q.device)[:, None, None]
        return torch.where(tok < n_dec, dec_out, pre_out)
    # Plain path: scatter every token, then attend. The builder never emits
    # an out-of-range slot; one would be redirected to the garbage page
    # (JAX drops it), never written elsewhere. An fp8 cache is un-scaled to
    # a plain f32 view of the layer first.
    S = cache.shape[1]
    pa.scale_lanes(cache, n_kv, hd)
    in_range = (batch.kv_slots >= 0) & (batch.kv_slots < S)
    slots = torch.where(in_range, batch.kv_slots, S - page_size).long()
    pa.as_bytes(cache)[layer, slots] = pa.as_bytes(kv_new)
    cache_l = cache[layer]
    if cache.dtype == pa.FP8:
        cache_l = pa.dequantize_kv(cache_l, n_kv * hd)
    return _ragged_paged_attention_torch(
        q, cache_l.view(S, 2, n_kv, hd), batch, page_size=page_size,
        sm_scale=sm_scale, q_bucket=q_bucket, window=window)


def quantized_proj(x: torch.Tensor, w: dict, layer: int) -> torch.Tensor:
    """x [T, K] @ layer ``layer`` of the stacked quantized weight ``w``
    (``{"q": [L, N, K], "s"}`` or ``{"q4": [L, N, K/2], "s"}``), through the
    kernel of its format: [T, N] in x's dtype."""
    if "q" in w:
        return int8_matmul.int8_proj_stacked(x, w["q"], w["s"], layer)
    return int4_matmul.int4_proj_stacked(x, w["q4"], w["s"], layer)


def forward_shard(params: dict, kv_cache: torch.Tensor, feedback: torch.Tensor,
                  batch: StepBatch, *, cfg: LlamaModelConfig, page_size: int,
                  q_bucket: int, use_kernels: bool,
                  return_logits: bool = False, use_sampler: bool = False,
                  return_logprobs: bool = False, kv_pend=None, npend: int = 0,
                  sample_span: int = 0, live_rows: int | None = None,
                  mesh: Mesh = SINGLE, bf16_scores: bool | None = None):
    """One step on this rank's shard: embedding, the layers, the final norm,
    the sampling head and the feedback write. ``kv_cache`` [L, S, W] and
    ``feedback`` i32[F] (this rank's) are updated IN PLACE (JAX donates them
    and returns new arrays); ``batch`` is this rank's dp group's.

    ``sample_span`` S1 > 0 (speculative verify steps): the head reads EVERY
    one of the first S1 positions of each row's span (pad positions read the
    zero row), so tokens, logits and logprobs come out [B * S1], row-major.
    Each row's sampler knobs repeat over its span, position j's seed is the
    row's seed + j (mod 2^32), and the feedback buffer gets each row's token
    at its last valid position. The engine's accept loop reads the rest.

    ``use_sampler`` (the bucket key's sampling bit) picks ``sample_tokens``
    over the greedy head, so an all-greedy batch never pays for the sampler.
    With ``kv_pend`` [L, P, B, W] (deferred commit, see
    ``decode_multi_step``) no layer writes the cache, and each layer's fresh
    rows ``kv_new[:B]`` come back stacked. ``live_rows`` (a host integer:
    rows from it on have no query) bounds the rows the attention kernels
    plan their key splits over. ``bf16_scores``: the prefill kernel's
    bf16-score variant (None: ``SWIFTLLM_TILE_BF16_SCORES`` at each call).

    Returns (tokens i32[dp*B], logits f32[dp*B, V_padded] or None[,
    logprobs f32[dp*B] with ``return_logprobs``][, kv_rows [L, B, W] with
    ``kv_pend``]); B becomes B * S1 with ``sample_span``. Tokens, logits and
    logprobs are gathered over tp and dp, the same on every rank; V_padded
    is the vocab padded to a multiple of tp, its padding -inf."""
    assert not (sample_span and kv_pend is not None), \
        "verify steps are single steps"
    T = batch.token_ids.shape[0]
    hd = cfg.head_dim
    sm_scale = 1.0 / math.sqrt(hd)
    eps = cfg.rms_norm_eps

    # Device-fed tokens: step N reads step N-1's samples (clamped gather).
    f_len = feedback.shape[0]
    fed = feedback[batch.feedback_read.clamp(0, f_len - 1)]
    token_ids = torch.where(batch.feedback_read >= 0, fed, batch.token_ids)

    # The vocab-sharded embedding: each rank gathers the ids it holds, the
    # all-reduce assembles the rows.
    embed = params["embed"]
    v_local = embed.shape[0]
    local_ids = token_ids - mesh.tp_rank * v_local if mesh.tp > 1 else token_ids
    in_range = (local_ids >= 0) & (local_ids < v_local)
    x = embed[local_ids.clamp(0, v_local - 1)]
    x = all_reduce_tp(torch.where(in_range[:, None], x,
                                  torch.zeros_like(x)), mesh)        # [T, D]
    n_kv = effective_num_kv_heads(cfg.num_kv_heads, mesh.tp) // mesh.tp

    rope_cs = rope_tables(batch.positions, params["inv_freq"], x.dtype)
    # The layer's elementwise work: its kernels, or their plain versions.
    # With an fp8 cache the RoPE kernel also builds the cache rows.
    fp8 = kv_cache.dtype == pa.FP8
    if use_kernels:
        add_rms_norm, silu_mul = lo.add_rms_norm, lo.silu_mul
        rope = lo.rope_qkv_fp8 if fp8 else lo.rope_qkv
    else:
        add_rms_norm, silu_mul = lo.add_rms_norm_plain, lo.silu_mul_plain
        rope = lo.rope_qkv_fp8_plain if fp8 else lo.rope_qkv_plain
    layers = params["layers"]
    # Multi-LoRA: each token's adapter scale, once a step (lora_add).
    sel = (lora_select(batch.lora_ids, params["lora_scale"])
           if "lora_scale" in params else None)
    # Quantized weights go through their format's kernel, which reads the
    # stacked array at the layer's offset; bf16 weights, and quantized ones
    # without kernels, through quant.proj.
    kv_rows = []
    r = None   # the branch output the next norm adds to the residual stream
    for layer in range(kv_cache.shape[0]):
        w = {name: (t[layer] if torch.is_tensor(t)
                    else {k: v[layer] for k, v in t.items()})
             for name, t in layers.items()}

        def mproj(h_, name):
            wt = layers[name]
            if use_kernels and is_quantized(wt):
                y = quantized_proj(h_, wt, layer)
            else:
                y = proj(h_, w[name])
            lw = w.get("lora_" + name)     # a projection an adapter targets
            return y if lw is None else lora_add(y, h_, lw["A"], lw["B"], sel)

        h, x = add_rms_norm(x, r, w["attn_norm"], eps)
        bias = (w["bq"], w["bk"], w["bv"]) if "bq" in w else None  # Qwen2
        q, kv_new = rope(mproj(h, "wq"), mproj(h, "wk"), mproj(h, "wv"),
                         rope_cs, bias)
        q = q.view(T, -1, hd)
        kv_new = kv_new.to(kv_cache.dtype)
        attn = _attention_and_store(
            q, kv_new, kv_cache, layer, batch, n_kv=n_kv,
            page_size=page_size, sm_scale=sm_scale, use_kernels=use_kernels,
            q_bucket=q_bucket, window=cfg.sliding_window or 0,
            kv_pend=kv_pend, npend=npend, live_rows=live_rows,
            bf16_scores=bf16_scores)
        if kv_pend is not None:
            kv_rows.append(kv_new[:batch.q_lens.shape[0]])
        # In-sharded projections: each rank's partial sum (an adapter's
        # included), then the all-reduce; the next norm adds the result to
        # the residual stream.
        h, x = add_rms_norm(x, all_reduce_tp(mproj(attn.reshape(T, -1), "wo"),
                                             mesh), w["ffn_norm"], eps)
        gate_up = silu_mul(mproj(h, "w_gate"), mproj(h, "w_up"))
        r = all_reduce_tp(mproj(gate_up, "w_down"), mesh)

    x, _ = add_rms_norm(x, r, params["final_norm"], eps)

    # The head reads each row's last fed token (pad rows -> the zero row),
    # or, in a verify step, every position of its span.
    B = batch.q_lens.shape[0]
    x_pad = torch.cat([x, x.new_zeros(1, x.shape[1])])
    if sample_span:
        sp = torch.arange(sample_span, device=x.device)
        sel_tok = torch.where(sp[None, :] < batch.q_lens[:, None],
                              batch.q_starts[:, None] + sp[None, :], T)
        h_last = x_pad[sel_tok.reshape(-1).clamp(0, T)]              # [B*S1, D]
    else:
        last_tok = torch.where(batch.q_lens > 0,
                               batch.q_starts + batch.q_lens - 1, T).clamp(0, T)
        h_last = x_pad[last_tok]                                     # [B, D]
    lm_head = params["lm_head"]
    if use_kernels and is_quantized(lm_head):
        # [V, D] as a one-layer stack (a view) for its format's kernel.
        logits = quantized_proj(h_last, {k: v[None] for k, v in lm_head.items()},
                                0).float()                           # [B, V]
    elif is_quantized(lm_head):  # [V, D], the [out, in] layout proj takes
        logits = proj(h_last, lm_head).float()                       # [B, V]
    else:
        logits = (h_last @ lm_head.to(h_last.dtype).T).float()       # [B, V]
    if mesh.tp * v_local != cfg.vocab_size:
        # The vocab padding (to a multiple of tp) never wins.
        ids = mesh.tp_rank * v_local + torch.arange(v_local, device=x.device)
        logits = logits.masked_fill(ids[None, :] >= cfg.vocab_size,
                                    float("-inf"))
    knobs = dict(temperature=batch.temperature, top_p=batch.top_p,
                 top_k=batch.top_k, seeds=batch.seeds)
    if sample_span:
        # Per-position knobs: each row's repeated over its span, the seed
        # advanced by the position (the JAX package's uint32 sum wraps).
        knobs = {k: v.repeat_interleave(sample_span) for k, v in knobs.items()}
        knobs["seeds"] = (knobs["seeds"].long()
                          + torch.arange(sample_span, device=x.device).repeat(B)
                          ) & 0xFFFFFFFF
    if use_sampler:
        tokens = sample_tokens(logits, mesh=mesh, **knobs)
    else:
        tokens = exact_greedy(logits, mesh)

    # Publish samples to the feedback buffer: in a verify step, each row's
    # token at its last valid position (the host's accept loop resolves the
    # token the row really continues with). Pad rows target the garbage
    # slot (the last); an out-of-range slot is redirected there too, where
    # JAX would drop the write.
    fb_val = tokens
    if sample_span:
        last = (batch.q_lens - 1).clamp(0, sample_span - 1).long()
        fb_val = tokens.view(B, sample_span).gather(1, last[:, None])[:, 0]
    fw = batch.feedback_write
    fw = torch.where((fw >= 0) & (fw < f_len), fw, f_len - 1).long()
    feedback[fw] = fb_val
    logprobs = chosen_logprobs(logits, tokens, mesh) if return_logprobs else None
    if return_logits and mesh.tp > 1:
        logits = gather_tp(logits, mesh).permute(1, 0, 2).flatten(1)
    # Every dp group's tokens (and logprobs, logits) on every rank: the
    # primary reads them all from its own.
    out = (gather_dp(tokens, mesh),
           gather_dp(logits, mesh) if return_logits else None)
    if return_logprobs:
        out += (gather_dp(logprobs, mesh),)
    if kv_pend is not None:
        out += (torch.stack(kv_rows),)
    return out


def advance_decode_batch(batch: StepBatch, s: int, *, page_size: int,
                         garbage_slot: int) -> StepBatch:
    """Shift a pure-decode StepBatch ``s`` decode steps forward, on the
    batch's device and without synchronising.

    The host builds the batch of a multi-step window's first step only;
    inner step ``s`` takes its positions, KV slots, sequence lengths and
    seeds from here, and reads its input tokens from the feedback buffer,
    where inner step ``s - 1`` wrote its samples. Pad tokens keep the garbage
    slot. ``build_step_batch`` allocated the pages of all S steps, so the
    page table is complete. The seeds come back as int64 holding the u32
    values ``(seeds + s) mod 2^32``."""
    T = batch.token_ids.shape[0]
    B, Pg = batch.page_table.shape
    live_row = batch.q_lens > 0                                    # [B]
    t_iota = torch.arange(T, device=batch.token_ids.device)
    row_of_t = t_iota.clamp(0, B - 1)     # decode contract: token t == row t
    live_t = (t_iota < B) & live_row[row_of_t]
    pos = batch.positions + s
    pidx = (pos // page_size).clamp(0, Pg - 1)
    page = batch.page_table[row_of_t, pidx]                        # [T]
    slots = torch.where(live_t, page * page_size + pos % page_size,
                        garbage_slot)
    # After the first inner step every live row's token comes from its OWN
    # feedback slot (multi-step batches sample every row: ``build_step_batch``
    # asserts it).
    fw_t = torch.where(batch.sample_mask[row_of_t],
                       batch.feedback_write[row_of_t], -1)
    feedback_read = (batch.feedback_read if s == 0
                     else torch.where(live_t, fw_t, -1))
    return dataclasses.replace(
        batch,
        positions=torch.where(live_t, pos, 0),
        kv_slots=slots,
        seq_lens=torch.where(live_row, batch.seq_lens + s, 0),
        feedback_read=feedback_read,
        seeds=(batch.seeds.long() + s) & 0xFFFFFFFF,
    )


def defer_kv_env() -> bool:
    """``SWIFTLLM_DEFER_KV=1`` (off by default, as in the JAX package)."""
    return os.environ.get("SWIFTLLM_DEFER_KV", "0") == "1"


def _defer_commit_ok(cfg: LlamaModelConfig, *, use_kernels: bool, fp8: bool,
                     multi_step: int, asked: bool | None = None) -> bool:
    """Whether multi-step decode runs in deferred-commit mode: the decode
    kernel's path must be on (the gather-based path has no pending-token
    semantics), the cache must hold unscaled rows (no fp8), a sliding window
    must not be narrower than the pending window, and the caller must ask
    for it: ``asked``, by default ``defer_kv_env()`` read at each call."""
    if not use_kernels or fp8:
        return False
    if not (defer_kv_env() if asked is None else asked):
        return False
    return not (cfg.sliding_window and cfg.sliding_window < multi_step)


def decode_multi_step(params: dict, kv_cache: torch.Tensor,
                      feedback: torch.Tensor, batch: StepBatch, *,
                      multi_step: int, page_size: int,
                      return_logprobs: bool = False,
                      defer_kv: bool | None = None, **fwd_kwargs):
    """S pure-decode steps from ONE dispatch: S calls of ``forward_shard``
    queued on the stream with nothing between them that waits for the card.
    The batch build, its copy to the card and the tokens' copy back are paid
    once per S tokens. Tokens come out [B * S] row-major (row b's inner step
    s at ``b * S + s``), and so do the logprobs.

    Deferred KV commit (``_defer_commit_ok``, asked by ``defer_kv``, by
    default ``SWIFTLLM_DEFER_KV`` at the call): the inner steps do not write
    the cache. Each layer's fresh K‖V rows go into a pending buffer
    [L, S, B, W]; the decode kernel's ``pend`` variant reads the window's
    completed tokens from it; and the whole window is committed with one
    scatter of L*S*B rows after the loop, dead rows to the garbage page.

    Returns (tokens i32[B*S][, logprobs f32[B*S]])."""
    cfg = fwd_kwargs["cfg"]
    deferred = _defer_commit_ok(
        cfg, use_kernels=fwd_kwargs.get("use_kernels", False),
        fp8=kv_cache.dtype == pa.FP8, multi_step=multi_step, asked=defer_kv)
    L, S_slots, W = kv_cache.shape
    B, Pg = batch.page_table.shape
    P = multi_step
    garbage_slot = S_slots - page_size
    # Slots of an earlier window's rows stay in the dead part of the buffer:
    # a step reads only the slots below npend - 1.
    pend = (torch.empty((L, P, B, W), dtype=kv_cache.dtype,
                        device=kv_cache.device) if deferred else None)
    tokens, logprobs = [], []
    for s in range(multi_step):
        bs = advance_decode_batch(batch, s, page_size=page_size,
                                  garbage_slot=garbage_slot)
        out = forward_shard(params, kv_cache, feedback, bs,
                            page_size=page_size,
                            return_logprobs=return_logprobs,
                            kv_pend=pend, npend=s + 1, **fwd_kwargs)
        tokens.append(out[0])
        if return_logprobs:
            logprobs.append(out[2])
        if deferred:
            pend[:, s] = out[-1]
    if deferred:
        # Commit the window: slot of (inner step j, row b), in the pending
        # buffer's own [P, B] order.
        live = batch.q_lens > 0                                     # [B]
        # (decode contract: flat token b is row b)
        pos = (batch.positions[:B][None, :]
               + torch.arange(P, device=kv_cache.device)[:, None])   # [P, B]
        page = torch.gather(batch.page_table.T, 0,
                            (pos // page_size).clamp(0, Pg - 1).long())
        slots = torch.where(live[None, :], page * page_size + pos % page_size,
                            garbage_slot)
        kv_cache[:, slots.reshape(-1).long()] = pend.view(L, P * B, W)
    out = (torch.stack(tokens, dim=1).reshape(-1),)
    if return_logprobs:
        out += (torch.stack(logprobs, dim=1).reshape(-1),)
    return out


class StepSwitches(NamedTuple):
    """The two environment switches a step reads: deferred KV commit
    (``SWIFTLLM_DEFER_KV``) and the prefill kernel's bf16 scores
    (``SWIFTLLM_TILE_BF16_SCORES``)."""
    defer_kv: bool
    bf16_scores: bool


def step_switches() -> StepSwitches:
    """The switches as the environment sets them now."""
    return StepSwitches(defer_kv_env(), pa.bf16_scores_env())


def make_step_fn(cfg: LlamaModelConfig, *, page_size: int, q_bucket: int,
                 use_kernels: bool, T: int, B: int, Pg: int,
                 return_logits: bool = False, use_sampler: bool = False,
                 return_logprobs: bool = False, sample_span: int = 0,
                 multi_step: int = 1, live_rows: int | None = None,
                 mesh: Mesh = SINGLE, switches: StepSwitches | None = None):
    """The step of one bucket (T tokens, B rows, Pg pages, q bucket
    ``q_bucket``, ``sample_span`` S1 > 0 for a verify step, ``multi_step``
    S > 1 for a window of S decode steps), the counterpart of the JAX
    package's ``make_step_fn``: ``step(params, kv_cache, feedback, flat)``
    unpacks the packed batch on the device and runs ``forward_shard`` or
    ``decode_multi_step``, updating the cache and the feedback buffer in
    place. Every int is closed over, the environment switches too (read
    here, once, unless ``switches`` gives them), so the step reads nothing
    on the host and a CUDA graph can hold it. Returns (tokens, logits or
    None, logprobs or None)."""
    assert multi_step <= 1 or (sample_span == 0 and not return_logits), \
        "multi_step is a pure-decode variant (no spec spans, no logits)"
    sw = switches or step_switches()
    kw = dict(cfg=cfg, page_size=page_size, q_bucket=q_bucket,
              use_kernels=use_kernels, use_sampler=use_sampler,
              return_logprobs=return_logprobs, live_rows=live_rows, mesh=mesh,
              bf16_scores=sw.bf16_scores)

    def step(params, kv_cache, feedback, flat):
        batch = unpack_step_batch(flat, T, B, Pg, page_size=page_size,
                                  garbage_slot=kv_cache.shape[1] - page_size)
        if multi_step > 1:
            tokens, *rest = decode_multi_step(
                params, kv_cache, feedback, batch, multi_step=multi_step,
                defer_kv=sw.defer_kv, **kw)
            return tokens, None, rest[0] if return_logprobs else None
        tokens, logits, *rest = forward_shard(
            params, kv_cache, feedback, batch, return_logits=return_logits,
            sample_span=sample_span, **kw)
        return tokens, logits, rest[0] if return_logprobs else None

    return step
