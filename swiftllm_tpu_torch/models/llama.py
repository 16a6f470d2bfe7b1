"""Llama-family forward pass for the PyTorch port, at tp = dp = 1.

A port of ``swiftllm_tpu/models/llama.py`` that keeps its names and layouts:

- The step consumes ONE flat token batch, decode tokens and prefill chunks
  mixed (SARATHI), described by a ``StepBatch`` that ``unpack_step_batch``
  rebuilds on the device from the packed i32 buffer of
  ``worker/batch_builder.pack_step_batch``.
- The paged KV cache is ``[L, S, W]``: S flat slots ((pages + 1) * page_size,
  the +1 a garbage page that padding tokens write into) and W = 2*n_kv*hd
  lanes laid out ``[K_all ‖ V_all]``. With ``kv_quant="fp8"`` the cache is
  ``torch.float8_e4m3fn`` and each row ends in ``FP8_SCALE_LANES`` more lanes
  that hold the token's power-of-two K and V scales (``quantize_kv``), byte
  for byte the JAX package's layout.
- A Python loop over layers replaces ``lax.scan``. Where JAX donates the
  cache and the feedback buffer to the step, this port updates both IN PLACE.
- Attention goes through the hand-written CUDA kernels of
  ``ops/paged_attention.py`` (``use_kernels``, the config's ``use_pallas``),
  or through ``_ragged_paged_attention_torch``, the port of the JAX package's
  gather-based reference. Projections, norms, RoPE, SiLU*mul, the embedding
  gather and the argmax are plain PyTorch, as the JAX package leaves them to
  XLA, with one exception: with ``use_kernels``, the INT4 weights of buckets
  of at most 256 tokens go through the INT4 kernel of
  ``ops/int4_matmul.py``. Every other quantized weight (INT8, INT4 in the
  prefill buckets, the quantized ``lm_head``) goes through ``quant.proj``.
- Multi-LoRA: a projection that an adapter targets adds each token's own
  adapter update (``lora_add``, plain GEMMs, as the JAX package leaves its
  einsums to XLA), in every step kind: mixed, multi-step and verify.

Numerics round where the JAX package rounds: RMSNorm casts back to the
activation dtype BEFORE the weight multiply, SiLU runs in f32 and is cast
back, and the logits are a product in the activation dtype cast to f32.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from swiftllm_tpu_torch.config import LlamaModelConfig
from swiftllm_tpu_torch.models.sampling import (chosen_logprobs, exact_greedy,
                                                sample_tokens)
from swiftllm_tpu_torch.ops import int4_matmul
from swiftllm_tpu_torch.ops import paged_attention as pa
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
    """cos/sin [T, 1, hd/2] in ``dtype``, computed once per step."""
    angles = positions.float()[:, None] * inv_freq[None, :]
    return (torch.cos(angles).to(dtype)[:, None, :],
            torch.sin(angles).to(dtype)[:, None, :])


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Half-split (rotate_half) rotary embedding, HF convention.
    x: [T, n_heads, head_dim]; tables: (cos, sin) from rope_tables."""
    cos, sin = tables
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# fp8 KV: per-token power-of-two scales, kept in the cache row's last lanes
# ---------------------------------------------------------------------------

FP8_SCALE_LANES = pa.FP8_SCALE_LANES


def fp8_scales(x_max: torch.Tensor) -> torch.Tensor:
    """Per-token power-of-2 scale s = 2^e with |x|*s <= 224 (e4m3's largest
    value is 448): e = floor(log2(224 / max(x_max, 1e-20))) clipped to
    [-9, 8], the powers of two that e4m3 holds exactly (2^-9 is its smallest
    subnormal), so the scale lanes lose nothing.

    The JAX package takes the floor of a float32 ``log2`` of the rounded
    quotient; this takes it exactly, from the exponent and mantissa of
    x_max (x = m * 2^ex with m in [0.5, 1): 224 / m lies in (224, 448], at
    or above 256 when m <= 0.875), so the CPU and the card give the same
    bytes. The two differ only where the reference's ``log2`` rounds up
    across an integer: x_max a few float32 ulps above 224 * 2^k, where the
    reference's scale is twice this one and both keep |x|*s within 448."""
    m, ex = torch.frexp(x_max.float().clamp(1e-20, torch.finfo(torch.float32).max))
    e = torch.where(m <= 0.875, 8, 7) - ex
    return torch.exp2(e.clamp(-9, 8).float())


def quantize_kv(kf: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
    """One step's K and V rows ([T, n_kv*hd] each, any float dtype) as fp8
    cache rows [T, 2*n_kv*hd + FP8_SCALE_LANES]: each token's K and V times
    its own scale (from the row's absmax), clipped to +-448 (e4m3fn has no
    inf: an overflowing cast would give NaN), then the scale lanes (K scale,
    V scale, zeros), all cast to e4m3 at once."""
    kv = torch.stack([kf, vf], dim=1).float()                         # [T, 2, KH]
    scales = fp8_scales(kv.abs().amax(dim=2))                         # [T, 2]
    lanes = kv.new_zeros(kv.shape[0], FP8_SCALE_LANES)
    lanes[:, :2] = scales
    stored = (kv * scales[:, :, None]).clamp(-448.0, 448.0)
    return torch.cat([stored.flatten(1), lanes], dim=1).to(pa.FP8)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF LlamaRMSNorm: f32 variance, cast back BEFORE the weight multiply."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


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
                         live_rows: int | None = None):
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
    integer: rows from it on have no query; None: any row may)."""
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
            batch.seq_lens, layer, q_bucket=q_bucket, **kern)
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


def forward_shard(params: dict, kv_cache: torch.Tensor, feedback: torch.Tensor,
                  batch: StepBatch, *, cfg: LlamaModelConfig, page_size: int,
                  q_bucket: int, use_kernels: bool,
                  return_logits: bool = False, use_sampler: bool = False,
                  return_logprobs: bool = False, kv_pend=None, npend: int = 0,
                  sample_span: int = 0, live_rows: int | None = None):
    """One step: embedding, the layers, the final norm, the sampling head and
    the feedback write. ``kv_cache`` [L, S, W] and ``feedback`` i32[F] are
    updated IN PLACE (JAX donates them and returns new arrays).

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
    plan their key splits over.

    Returns (tokens i32[B], logits f32[B, V] or None[, logprobs f32[B] with
    ``return_logprobs``][, kv_rows [L, B, W] with ``kv_pend``]); B becomes
    B * S1 with ``sample_span``."""
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

    embed = params["embed"]
    vocab = embed.shape[0]
    in_range = (token_ids >= 0) & (token_ids < vocab)
    x = embed[token_ids.clamp(0, vocab - 1)]
    x = torch.where(in_range[:, None], x, torch.zeros_like(x))       # [T, D]

    rope_cs = rope_tables(batch.positions, params["inv_freq"], x.dtype)
    layers = params["layers"]
    # Multi-LoRA: each token's adapter scale, once a step (lora_add).
    sel = (lora_select(batch.lora_ids, params["lora_scale"])
           if "lora_scale" in params else None)
    # INT4 weights of decode-size buckets go through the INT4 kernel, which
    # reads the stacked [L, N, K/2] array at the layer's offset (the JAX gate
    # on T); every other projection through quant.proj.
    int4_kernel = use_kernels and T <= int4_matmul.MAX_T
    kv_rows = []
    for layer in range(kv_cache.shape[0]):
        w = {name: (t[layer] if torch.is_tensor(t)
                    else {k: v[layer] for k, v in t.items()})
             for name, t in layers.items()}

        def mproj(h_, name):
            wt = layers[name]
            if int4_kernel and is_quantized(wt) and "q4" in wt:
                y = int4_matmul.int4_proj_stacked(h_, wt["q4"], wt["s"], layer)
            else:
                y = proj(h_, w[name])
            lw = w.get("lora_" + name)     # a projection an adapter targets
            return y if lw is None else lora_add(y, h_, lw["A"], lw["B"], sel)

        h = rms_norm(x, w["attn_norm"], eps)
        q_flat = mproj(h, "wq")
        k_flat = mproj(h, "wk")
        v_flat = mproj(h, "wv")
        if "bq" in w:   # Qwen2-style q/k/v bias
            q_flat = q_flat + w["bq"].to(q_flat.dtype)
            k_flat = k_flat + w["bk"].to(k_flat.dtype)
            v_flat = v_flat + w["bv"].to(v_flat.dtype)
        q = apply_rope(q_flat.view(T, -1, hd), rope_cs)
        k = apply_rope(k_flat.view(T, -1, hd), rope_cs)
        if kv_cache.dtype == pa.FP8:
            kv_new = quantize_kv(k.reshape(T, -1), v_flat)
        else:
            kv_new = torch.cat([k.reshape(T, -1), v_flat], dim=1).to(kv_cache.dtype)
        attn = _attention_and_store(
            q, kv_new, kv_cache, layer, batch, n_kv=cfg.num_kv_heads,
            page_size=page_size, sm_scale=sm_scale, use_kernels=use_kernels,
            q_bucket=q_bucket, window=cfg.sliding_window or 0,
            kv_pend=kv_pend, npend=npend, live_rows=live_rows)
        if kv_pend is not None:
            kv_rows.append(kv_new[:batch.q_lens.shape[0]])
        x = x + mproj(attn.reshape(T, -1), "wo")

        h = rms_norm(x, w["ffn_norm"], eps)
        gate = F.silu(mproj(h, "w_gate").float()).to(x.dtype)
        x = x + mproj(gate * mproj(h, "w_up"), "w_down")

    x = rms_norm(x, params["final_norm"], eps)

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
    if is_quantized(lm_head):    # [V, D], the [out, in] layout proj takes
        logits = proj(h_last, lm_head).float()                       # [B, V]
    else:
        logits = (h_last @ lm_head.to(h_last.dtype).T).float()       # [B, V]
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
        tokens = sample_tokens(logits, **knobs)
    else:
        tokens = exact_greedy(logits)

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
    out = (tokens, logits if return_logits else None)
    if return_logprobs:
        out += (chosen_logprobs(logits, tokens),)
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


def _defer_commit_ok(cfg: LlamaModelConfig, *, use_kernels: bool, fp8: bool,
                     multi_step: int) -> bool:
    """Whether multi-step decode runs in deferred-commit mode: the decode
    kernel's path must be on (the gather-based path has no pending-token
    semantics), the cache must hold unscaled rows (no fp8), a sliding window
    must not be narrower than the pending window, and the caller must ask
    for it with ``SWIFTLLM_DEFER_KV=1`` (off by default, as in the JAX
    package; the environment is read at each call)."""
    if not use_kernels or fp8:
        return False
    if os.environ.get("SWIFTLLM_DEFER_KV", "0") != "1":
        return False
    return not (cfg.sliding_window and cfg.sliding_window < multi_step)


def decode_multi_step(params: dict, kv_cache: torch.Tensor,
                      feedback: torch.Tensor, batch: StepBatch, *,
                      multi_step: int, page_size: int,
                      return_logprobs: bool = False, **fwd_kwargs):
    """S pure-decode steps from ONE dispatch: S calls of ``forward_shard``
    queued on the stream with nothing between them that waits for the card.
    The batch build, its copy to the card and the tokens' copy back are paid
    once per S tokens. Tokens come out [B * S] row-major (row b's inner step
    s at ``b * S + s``), and so do the logprobs.

    Deferred KV commit (``_defer_commit_ok``): the inner steps do not write
    the cache. Each layer's fresh K‖V rows go into a pending buffer
    [L, S, B, W]; the decode kernel's ``pend`` variant reads the window's
    completed tokens from it; and the whole window is committed with one
    scatter of L*S*B rows after the loop, dead rows to the garbage page.

    Returns (tokens i32[B*S][, logprobs f32[B*S]])."""
    cfg = fwd_kwargs["cfg"]
    deferred = _defer_commit_ok(
        cfg, use_kernels=fwd_kwargs.get("use_kernels", False),
        fp8=kv_cache.dtype == pa.FP8, multi_step=multi_step)
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
