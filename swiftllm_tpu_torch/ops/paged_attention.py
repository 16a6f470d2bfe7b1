"""Ragged paged attention for the PyTorch port: CUDA kernels written by hand
for Hopper (sm_90a), their plain PyTorch versions, and launch counters.

Contract (the same as ``swiftllm_tpu/ops/paged_attention.py``): batch row b
has q_lens[b] query tokens, contiguous in the flat token stream starting at
q_starts[b]; they are the LAST q_lens[b] positions of a sequence whose total
KV length (after this step's cache writes) is seq_lens[b], with KV living in
pages page_table[b]. Causal within the tail: query i of row b has position
seq_lens[b] - q_lens[b] + i.

The cache is ``[L, S, W]``: slot s of layer l is ``cache[l, s]``, page p holds
slots ``p*page_size .. p*page_size+page_size-1``, and the lanes are laid out
``[K_all ‖ V_all]`` (the n_kv K heads, then the n_kv V heads), W = 2*n_kv*hd.
An fp8 cache (``torch.float8_e4m3fn``, ``kv_quant="fp8"``) appends one tile of
``FP8_SCALE_LANES`` = 128 lanes, W = 2*n_kv*hd + 128: lane 2*n_kv*hd holds the
token's K scale and the next lane its V scale (powers of two, stored as e4m3
themselves), the rest zero; the K and V lanes hold the true values TIMES
their scale, and ``kv_new`` rows come in the same form. Every entry takes
``n_kv`` (the lane count alone no longer gives it) and ``window``: with
``window`` > 0 a query at position p sees only the keys in (p - window, p];
0 means full causal attention.

- ``paged_decode_attention`` (TPU: ``_decode_kernel_grouped``): rows with one
  query, packed so flat token b is row b; valid rows must form a prefix of
  the row axis. It writes ``kv_new[b]`` to slot ``kv_slots[b]`` itself.
- ``paged_decode_attention_pend`` (TPU: the same kernel's ``pend`` mode,
  deferred commit): the same attention for inner step ``npend - 1`` of a
  multi-step window whose tokens are not in the cache yet. The cached history
  is ``seq_lens[b] - npend`` keys; the window's ``npend - 1`` completed tokens
  come from ``kv_pend[layer, j, b]`` and the current one from ``kv_new[b]``.
  It writes nothing: the caller commits the window afterwards.
- ``store_kv`` + ``paged_prefill_attention`` (TPU: ``_tiles_kernel`` with its
  fused span write): the write is a launch of its own, before the attention,
  because the blocks of one GPU grid run at once (see ``csrc/store_kv.cu``).
  The pair is also the TPU kernel's unfused mode, which speculative verify
  steps take: their spans start and end anywhere in a page.
- ``paged_prefill_attention_bf16s`` (TPU: ``_tiles_kernel`` under
  ``SWIFTLLM_TILE_BF16_SCORES=1``): the same attention with the scores, the
  exp2 pass and P in bf16. ``paged_prefill_attention`` takes it, at each
  call, when that variable is 1, the cache is not fp8 and there is no window.

Each wrapper takes its plain version for tensors on the CPU, and only then.
On a CUDA tensor it launches its kernel or raises; it never falls back. The
kernels are built and bound by ``ops/build.py`` (``nvcc`` at first use,
``ctypes``), launched on ``torch.cuda.current_stream()``, and never
synchronise. Every launch adds one to ``build.launch_counts[name]``.
"""

from __future__ import annotations

import math
import os

import torch

from swiftllm_tpu_torch.ops import build

# The C entries every serving step of this module's path can launch (sources
# in build.SOURCES). The deferred-commit and bf16-score variants run only
# when their environment variable asks for them.
KERNELS = ("paged_decode_attention", "store_kv", "paged_prefill_attention")

FP8 = torch.float8_e4m3fn
FP8_SCALE_LANES = 128   # lanes appended to an fp8 cache row (see above)

_HINT = " (an unsupported head_dim / GQA group returns 1)"


def max_pages_cap(page_size: int) -> int:
    """Largest pages-per-seq bucket the kernels take. They read the page table
    from device memory, so nothing caps it but the int32 token positions they
    index with (the JAX kernels' scalar-memory caps have no counterpart). It
    lies far above any pool a card holds, so in practice the pool binds."""
    return (2**31 - 1) // page_size


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return build.on_cpu("paged attention", *tensors)


def _check_types(floats, kv, ints) -> None:
    """The kernels' types: bf16 queries, cache tensors (the cache, kv_new) all
    bf16 or all float8_e4m3fn, int32 indices."""
    for t in floats:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bfloat16, got {t.dtype}")
    if kv[0].dtype not in (torch.bfloat16, FP8) or any(
            t.dtype != kv[0].dtype for t in kv):
        raise TypeError("the CUDA kernels take a bfloat16 or float8_e4m3fn "
                        f"cache, got {[t.dtype for t in kv]}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")


def scale_lanes(cache: torch.Tensor, n_kv: int, hd: int) -> int:
    """Lanes of ``cache`` past its K and V halves: 0, or FP8_SCALE_LANES for
    an fp8 cache. Anything else raises."""
    SL = cache.shape[-1] - 2 * n_kv * hd
    if SL != (FP8_SCALE_LANES if cache.dtype == FP8 else 0):
        raise ValueError(f"cache lanes {cache.shape[-1]} of {cache.dtype} vs "
                         f"2*n_kv*hd = {2 * n_kv * hd}")
    return SL


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its bytes (a uint8 view of the same memory), any
    other tensor as it is. Scatters and gathers of fp8 rows go by bytes: they
    copy, and not every backend indexes float8 tensors."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def dequantize_kv(kv: torch.Tensor, KH: int) -> torch.Tensor:
    """Rows ``[..., W]`` of a cache as f32 ``[..., 2*KH]`` of true values: an
    fp8 row's stored K and V lanes over its scales (a never-written slot has
    scale 0, guarded; it is never a visible key)."""
    f = kv.float()
    if kv.dtype != FP8:
        return f
    ks = f[..., 2 * KH:2 * KH + 1].clamp_min(1e-20)
    vs = f[..., 2 * KH + 1:2 * KH + 2].clamp_min(1e-20)
    return torch.cat([f[..., :KH] / ks, f[..., KH:2 * KH] / vs], dim=-1)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path; the card holds each kernel against these)
# ---------------------------------------------------------------------------

def _row_slots(page_table_row, n_keys: int, page_size: int,
               n_pages: int) -> torch.Tensor:
    """Cache slots of positions 0 .. n_keys-1 of one row, with the page column
    and the page id clamped as the kernels clamp them."""
    pos = torch.arange(n_keys, device=page_table_row.device)
    col = (pos // page_size).clamp(max=page_table_row.shape[0] - 1)
    page = page_table_row[col].long().clamp(0, n_pages - 1)
    return page * page_size + pos % page_size


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _attend(q: torch.Tensor, kv: torch.Tensor, q_pos: torch.Tensor,
            n_kv: int, sm_scale: float, window: int,
            bf16_scores: bool = False) -> torch.Tensor:
    """q [n, n_q, hd] over one row's keys kv [K, W] (key k at position k; an
    fp8 row is un-scaled by its own lanes), causal by q_pos [n] and within
    ``window`` of it; f32 scores and softmax, output in q's dtype.

    ``bf16_scores``: the bf16-score variant's rounding, in log2 space, with
    the row's maximum over all its visible keys (the kernel's running
    maximum moves tile by tile, so the two round the exponent argument
    against different m): raw scores to bf16; the argument
    bf16(bf16(s * bf16(K2E)) - bf16(m)), K2E = sm_scale * log2(e); P =
    bf16(exp2(argument)); m, l and the sum of P.V in f32."""
    n, n_q, hd = q.shape
    K = kv.shape[0]
    KH = n_kv * hd
    kvf = dequantize_kv(kv, KH)
    k = kvf[:, :KH].reshape(K, n_kv, hd)
    v = kvf[:, KH:].reshape(K, n_kv, hd)
    qf = q.float().reshape(n, n_kv, n_q // n_kv, hd)
    s = torch.einsum("nhgd,khd->hgnk", qf, k)
    key_pos = torch.arange(K, device=q.device)[None, :]
    q_pos = q_pos.to(q.device)[:, None]
    visible = key_pos <= q_pos                                        # [n, K]
    if window:
        visible &= key_pos > q_pos - window
    if bf16_scores:
        k2e = sm_scale * math.log2(math.e)
        k2e_b = float(torch.tensor(k2e).bfloat16())
        s = _round_bf16(s)
        m = s.masked_fill(~visible, float("-inf")).amax(-1, keepdim=True) * k2e
        arg = _round_bf16(_round_bf16(s * k2e_b) - _round_bf16(m))
        p = _round_bf16(torch.exp2(arg)) * visible
        o = torch.einsum("hgnk,khd->nhgd", p, v) / p.sum(-1).permute(2, 0, 1)[..., None]
        return o.reshape(n, n_q, hd).to(q.dtype)
    p = torch.softmax((s * sm_scale).masked_fill(~visible, float("-inf")), dim=-1)
    return torch.einsum("hgnk,khd->nhgd", p, v).reshape(n, n_q, hd).to(q.dtype)


def bf16_scores_on(cache: torch.Tensor, window: int) -> bool:
    """Whether a multi-token attention call takes the bf16-score variant:
    ``SWIFTLLM_TILE_BF16_SCORES=1`` (read at each call, off by default, as in
    the JAX package), a cache that is not fp8, and no window. An fp8 or a
    windowed call keeps f32 scores, as the JAX gate does."""
    return (os.environ.get("SWIFTLLM_TILE_BF16_SCORES", "0") == "1"
            and cache.dtype != FP8 and not window)


def paged_decode_attention_plain(q, cache, kv_new, page_table, q_lens,
                                 seq_lens, kv_slots, layer: int, *, n_kv: int,
                                 page_size: int, sm_scale: float,
                                 window: int = 0):
    """Plain version of ``paged_decode_attention``: the same writes to
    ``cache`` (in place) and the same output. The new token's key is read
    from ``kv_new`` as stored (quantized, with an fp8 cache)."""
    T, n_q, hd = q.shape
    B = page_table.shape[0]
    S = cache.shape[1]
    scale_lanes(cache, n_kv, hd)
    cache_b, new_b = as_bytes(cache), as_bytes(kv_new)
    out = torch.zeros_like(q)
    ql, sl, slots = q_lens.tolist(), seq_lens.tolist(), kv_slots.tolist()
    for b in range(min(B, T)):
        if ql[b] <= 0 or sl[b] <= 0:
            continue
        if 0 <= slots[b] < S:
            cache_b[layer, slots[b]] = new_b[b]
        hist = _row_slots(page_table[b], sl[b] - 1, page_size, S // page_size)
        kv = torch.cat([cache_b[layer, hist], new_b[b:b + 1]]).view(cache.dtype)
        out[b:b + 1] = _attend(q[b:b + 1], kv, torch.tensor([sl[b] - 1]),
                               n_kv, sm_scale, window)
    return out


def paged_decode_attention_pend_plain(q, cache, kv_new, kv_pend, page_table,
                                      q_lens, seq_lens, layer: int, *,
                                      npend: int, n_kv: int, page_size: int,
                                      sm_scale: float, window: int = 0):
    """Plain version of ``paged_decode_attention_pend``: each row's cached
    keys gathered from its pages, its live pending rows and its new row
    appended. The cache is only read."""
    T, n_q, hd = q.shape
    B = page_table.shape[0]
    S = cache.shape[1]
    _check_pend(cache, kv_new, kv_pend, npend, n_kv, hd, B)
    out = torch.zeros_like(q)
    ql, sl = q_lens.tolist(), seq_lens.tolist()
    for b in range(min(B, T)):
        if ql[b] <= 0 or sl[b] <= 0:
            continue
        hist = max(sl[b] - npend, 0)
        slots = _row_slots(page_table[b], hist, page_size, S // page_size)
        kv = torch.cat([cache[layer, slots],
                        kv_pend[layer, :sl[b] - 1 - hist, b], kv_new[b:b + 1]])
        out[b:b + 1] = _attend(q[b:b + 1], kv, torch.tensor([sl[b] - 1]),
                               n_kv, sm_scale, window)
    return out


def _check_pend(cache, kv_new, kv_pend, npend: int, n_kv: int, hd: int,
                B: int) -> None:
    """The deferred-commit entry's shapes: unscaled rows (no fp8), kv_pend
    [L, P, B, W] beside cache [L, S, W], 1 <= npend <= P."""
    if cache.dtype == FP8 or scale_lanes(cache, n_kv, hd):
        raise TypeError("deferred commit takes a cache of unscaled rows, "
                        "not float8_e4m3fn")
    L, _, W = cache.shape
    if (kv_pend.dim() != 4 or kv_pend.shape[0] != L or kv_pend.shape[2] != B
            or kv_pend.shape[3] != W or kv_new.shape[1] != W
            or not 1 <= npend <= kv_pend.shape[1]):
        raise ValueError(f"pend shapes: cache {tuple(cache.shape)}, kv_new "
                         f"{tuple(kv_new.shape)}, kv_pend "
                         f"{tuple(kv_pend.shape)}, rows {B}, npend {npend}")


def store_kv_plain(cache, kv_new, kv_slots, layer: int) -> None:
    """Plain version of ``store_kv``: cache[layer, kv_slots[t]] = kv_new[t]
    for every in-range slot (in place)."""
    keep = (kv_slots >= 0) & (kv_slots < cache.shape[1])
    as_bytes(cache)[layer, kv_slots[keep].long()] = as_bytes(kv_new)[keep]


def paged_prefill_attention_plain(q, cache, page_table, q_starts, q_lens,
                                  seq_lens, layer: int, *, n_kv: int,
                                  page_size: int, sm_scale: float,
                                  window: int = 0, bf16_scores: bool = False):
    """Plain version of ``paged_prefill_attention`` (and, with
    ``bf16_scores``, of its bf16-score variant). Tokens of no row are 0."""
    S = cache.shape[1]
    scale_lanes(cache, n_kv, q.shape[2])
    cache_b = as_bytes(cache)
    out = torch.zeros_like(q)
    st, ql, sl = q_starts.tolist(), q_lens.tolist(), seq_lens.tolist()
    for b in range(len(ql)):
        if ql[b] <= 0 or sl[b] <= 0:
            continue
        slots = _row_slots(page_table[b], sl[b], page_size, S // page_size)
        q_pos = torch.arange(sl[b] - ql[b], sl[b])
        out[st[b]:st[b] + ql[b]] = _attend(
            q[st[b]:st[b] + ql[b]], cache_b[layer, slots].view(cache.dtype),
            q_pos, n_kv, sm_scale, window, bf16_scores)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def paged_decode_attention(q, cache, kv_new, page_table, q_lens, seq_lens,
                           kv_slots, layer: int, *, n_kv: int, page_size: int,
                           sm_scale: float, window: int = 0):
    """Decode attention with the KV write fused in.

    q [T, n_q, hd], cache [L, S, W] (updated in place), kv_new [T, W] in the
    cache's dtype, page_table i32[B, Pg], q_lens/seq_lens i32[B], kv_slots
    i32[T>=B]. Returns out [T, n_q, hd]: row b's attention for every valid
    row (q_lens[b] > 0, flat token b), zeros elsewhere."""
    args = (q, cache, kv_new, page_table, q_lens, seq_lens, kv_slots)
    if _on_cpu(*args):
        return paged_decode_attention_plain(
            *args, layer, n_kv=n_kv, page_size=page_size, sm_scale=sm_scale,
            window=window)
    _check_types((q,), (cache, kv_new),
                 (page_table, q_lens, seq_lens, kv_slots))
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    _, S, W = cache.shape
    scale_lanes(cache, n_kv, hd)
    if T < B or kv_new.shape != (T, W) or window < 0:
        raise ValueError(f"decode shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(cache.shape)}, kv_new {tuple(kv_new.shape)}, "
                         f"page_table {tuple(page_table.shape)}, window {window}")
    out = torch.empty_like(q)
    err = build.entry("paged_decode_attention")(
        q.data_ptr(), cache.data_ptr(), kv_new.data_ptr(),
        page_table.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        kv_slots.data_ptr(), out.data_ptr(), T, B, Pg, n_q, n_kv, hd, S,
        int(layer), page_size, int(window), int(cache.dtype == FP8),
        float(sm_scale), build.stream())
    build.check_launch("paged_decode_attention", err, _HINT)
    return out


def paged_decode_attention_pend(q, cache, kv_new, kv_pend, page_table, q_lens,
                                seq_lens, layer: int, *, npend: int,
                                n_kv: int, page_size: int, sm_scale: float,
                                window: int = 0):
    """Decode attention in deferred-commit mode: no cache write.

    q [T, n_q, hd], cache [L, S, W] bf16 (read only), kv_new [T, W], kv_pend
    [L, P, B, W] in the cache's dtype, page_table i32[B, Pg], q_lens/seq_lens
    i32[B]; ``npend`` in 1..P is the same for every row (inner step
    ``npend - 1`` of the window). Key ``pos`` of row b comes from the pages
    for ``pos < hist = max(seq_lens[b] - npend, 0)``, from
    ``kv_pend[layer, pos - hist, b]`` for ``hist <= pos < seq_lens[b] - 1``
    and from ``kv_new[b]`` for the last. Pending slots from ``npend - 1`` on
    are never read. Returns out [T, n_q, hd], zeros at rows that are not
    valid."""
    args = (q, cache, kv_new, kv_pend, page_table, q_lens, seq_lens)
    if _on_cpu(*args):
        return paged_decode_attention_pend_plain(
            *args, layer, npend=npend, n_kv=n_kv, page_size=page_size,
            sm_scale=sm_scale, window=window)
    _check_types((q,), (cache, kv_new, kv_pend),
                 (page_table, q_lens, seq_lens))
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    _, S, W = cache.shape
    _check_pend(cache, kv_new, kv_pend, npend, n_kv, hd, B)
    if T < B or kv_new.shape != (T, W) or window < 0:
        raise ValueError(f"decode shapes: q {tuple(q.shape)}, kv_new "
                         f"{tuple(kv_new.shape)}, page_table "
                         f"{tuple(page_table.shape)}, window {window}")
    out = torch.empty_like(q)
    err = build.entry("paged_decode_attention_pend")(
        q.data_ptr(), cache.data_ptr(), kv_new.data_ptr(), kv_pend.data_ptr(),
        page_table.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), T, B, Pg, n_q, n_kv, hd, S, int(layer), page_size,
        int(window), int(npend), kv_pend.shape[1], float(sm_scale),
        build.stream())
    build.check_launch("paged_decode_attention_pend", err, _HINT)
    return out


def store_kv(cache, kv_new, kv_slots, layer: int) -> None:
    """cache[layer, kv_slots[t]] = kv_new[t] for every in-range slot, in
    place. cache [L, S, W], kv_new [T, W], kv_slots i32[T]."""
    if _on_cpu(cache, kv_new, kv_slots):
        store_kv_plain(cache, kv_new, kv_slots, layer)
        return
    _check_types((), (cache, kv_new), (kv_slots,))
    T, W = kv_new.shape
    row_bytes = W * kv_new.element_size()
    if cache.shape[2] != W or row_bytes % 16 or kv_slots.shape != (T,):
        raise ValueError(f"store_kv shapes: cache {tuple(cache.shape)}, "
                         f"kv_new {tuple(kv_new.shape)}, "
                         f"kv_slots {tuple(kv_slots.shape)}")
    if T == 0:
        return
    err = build.entry("store_kv")(kv_new.data_ptr(), cache.data_ptr(),
                                  kv_slots.data_ptr(), T, row_bytes,
                                  cache.shape[1], int(layer), build.stream())
    build.check_launch("store_kv", err, _HINT)


def paged_prefill_attention(q, cache, page_table, q_starts, q_lens, seq_lens,
                            layer: int, *, n_kv: int, page_size: int,
                            sm_scale: float, q_bucket: int, window: int = 0):
    """Causal attention of multi-token rows over the cache (their new KV is
    already stored). q [T, n_q, hd]; q_bucket bounds every q_lens[b].
    Returns out [T, n_q, hd], zeros at tokens of no row.

    A row's span may start and end anywhere in a page: row b's queries are
    flat tokens q_starts[b] .. q_starts[b] + q_lens[b] - 1 at positions
    seq_lens[b] - q_lens[b] .. seq_lens[b] - 1, with no alignment of either.
    A speculative verify step ([next token] + drafts, q_bucket =
    next_pow2(spec_k + 1)) relies on it, and on this: no key at or past
    seq_lens[b] is read, so slots that still hold rejected drafts of an
    earlier step are invisible once seq_lens[b] stops short of them.

    With ``bf16_scores_on`` (``SWIFTLLM_TILE_BF16_SCORES=1``, a cache that is
    not fp8, no window) it launches ``paged_prefill_attention_bf16s``, whose
    launches count under that name."""
    args = (q, cache, page_table, q_starts, q_lens, seq_lens)
    bf16s = bf16_scores_on(cache, window)
    if _on_cpu(*args):
        return paged_prefill_attention_plain(
            *args, layer, n_kv=n_kv, page_size=page_size, sm_scale=sm_scale,
            window=window, bf16_scores=bf16s)
    _check_types((q,), (cache,), (page_table, q_starts, q_lens, seq_lens))
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    S = cache.shape[1]
    scale_lanes(cache, n_kv, hd)
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.zeros_like(q)
    if bf16s:
        err = build.entry("paged_prefill_attention_bf16s")(
            q.data_ptr(), cache.data_ptr(), page_table.data_ptr(),
            q_starts.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), B, int(q_bucket), Pg, n_q, n_kv, hd, S,
            int(layer), page_size, float(sm_scale), build.stream())
        build.check_launch("paged_prefill_attention_bf16s", err, _HINT)
        return out
    err = build.entry("paged_prefill_attention")(
        q.data_ptr(), cache.data_ptr(), page_table.data_ptr(),
        q_starts.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, int(q_bucket), Pg, n_q, n_kv, hd, S, int(layer),
        page_size, int(window), int(cache.dtype == FP8), float(sm_scale),
        build.stream())
    build.check_launch("paged_prefill_attention", err, _HINT)
    return out
