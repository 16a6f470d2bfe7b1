"""Ragged paged attention for the PyTorch port: three CUDA kernels written by
hand for Hopper (sm_90a), their plain PyTorch versions, and launch counters.

Contract (the same as ``swiftllm_tpu/ops/paged_attention.py``): batch row b
has q_lens[b] query tokens, contiguous in the flat token stream starting at
q_starts[b]; they are the LAST q_lens[b] positions of a sequence whose total
KV length (after this step's cache writes) is seq_lens[b], with KV living in
pages page_table[b]. Causal within the tail: query i of row b has position
seq_lens[b] - q_lens[b] + i.

The cache is ``[L, S, W]``: slot s of layer l is ``cache[l, s]``, page p holds
slots ``p*page_size .. p*page_size+page_size-1``, and the W = 2*n_kv*hd lanes
are laid out ``[K_all ‖ V_all]`` (the n_kv K heads, then the n_kv V heads).

- ``paged_decode_attention`` (TPU: ``_decode_kernel_grouped``): rows with one
  query, packed so flat token b is row b; valid rows must form a prefix of
  the row axis. It writes ``kv_new[b]`` to slot ``kv_slots[b]`` itself.
- ``store_kv`` + ``paged_prefill_attention`` (TPU: ``_tiles_kernel`` with its
  fused span write): the write is a launch of its own, before the attention,
  because the blocks of one GPU grid run at once (see ``csrc/store_kv.cu``).

Each wrapper takes its plain version for tensors on the CPU, and only then.
On a CUDA tensor it launches its kernel or raises; it never falls back. The
kernels are built and bound by ``ops/build.py`` (``nvcc`` at first use,
``ctypes``), launched on ``torch.cuda.current_stream()``, and never
synchronise. Every launch adds one to ``build.launch_counts[name]``.
"""

from __future__ import annotations

import torch

from swiftllm_tpu_torch.ops import build

# The C entries of this module's kernels (sources in build.SOURCES).
KERNELS = ("paged_decode_attention", "store_kv", "paged_prefill_attention")

_HINT = " (an unsupported head_dim / GQA group returns 1)"


def max_pages_cap(page_size: int) -> int:
    """Largest pages-per-seq bucket the kernels take. They read the page table
    from device memory, so nothing caps it but the int32 token positions they
    index with (the JAX kernels' scalar-memory caps have no counterpart). It
    lies far above any pool a card holds, so in practice the pool binds."""
    return (2**31 - 1) // page_size


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return build.on_cpu("paged attention", *tensors)


def _check_types(floats, ints) -> None:
    for t in floats:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bfloat16, got {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")


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


def _attend(q: torch.Tensor, kv: torch.Tensor, q_pos: torch.Tensor,
            n_kv: int, sm_scale: float) -> torch.Tensor:
    """q [n, n_q, hd] over one row's keys kv [K, W] (key k at position k),
    causal by q_pos [n]; f32 scores and softmax, output in q's dtype."""
    n, n_q, hd = q.shape
    K = kv.shape[0]
    KH = n_kv * hd
    k = kv[:, :KH].float().reshape(K, n_kv, hd)
    v = kv[:, KH:2 * KH].float().reshape(K, n_kv, hd)
    qf = q.float().reshape(n, n_kv, n_q // n_kv, hd)
    s = torch.einsum("nhgd,khd->hgnk", qf, k) * sm_scale
    visible = (torch.arange(K, device=q.device)[None, :]
               <= q_pos.to(q.device)[:, None])                        # [n, K]
    p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
    return torch.einsum("hgnk,khd->nhgd", p, v).reshape(n, n_q, hd).to(q.dtype)


def paged_decode_attention_plain(q, cache, kv_new, page_table, q_lens,
                                 seq_lens, kv_slots, layer: int, *,
                                 page_size: int, sm_scale: float):
    """Plain version of ``paged_decode_attention``: the same writes to
    ``cache`` (in place) and the same output."""
    T, n_q, hd = q.shape
    B = page_table.shape[0]
    S, W = cache.shape[1], cache.shape[2]
    n_kv = W // (2 * hd)
    out = torch.zeros_like(q)
    ql, sl, slots = q_lens.tolist(), seq_lens.tolist(), kv_slots.tolist()
    for b in range(min(B, T)):
        if ql[b] <= 0 or sl[b] <= 0:
            continue
        if 0 <= slots[b] < S:
            cache[layer, slots[b]] = kv_new[b]
        hist = _row_slots(page_table[b], sl[b] - 1, page_size, S // page_size)
        kv = torch.cat([cache[layer, hist], kv_new[b:b + 1]])
        out[b:b + 1] = _attend(q[b:b + 1], kv,
                               torch.tensor([sl[b] - 1]), n_kv, sm_scale)
    return out


def store_kv_plain(cache, kv_new, kv_slots, layer: int) -> None:
    """Plain version of ``store_kv``: cache[layer, kv_slots[t]] = kv_new[t]
    for every in-range slot (in place)."""
    keep = (kv_slots >= 0) & (kv_slots < cache.shape[1])
    cache[layer, kv_slots[keep].long()] = kv_new[keep]


def paged_prefill_attention_plain(q, cache, page_table, q_starts, q_lens,
                                  seq_lens, layer: int, *, page_size: int,
                                  sm_scale: float):
    """Plain version of ``paged_prefill_attention``. Tokens of no row are 0."""
    n_q, hd = q.shape[1], q.shape[2]
    S, W = cache.shape[1], cache.shape[2]
    n_kv = W // (2 * hd)
    out = torch.zeros_like(q)
    st, ql, sl = q_starts.tolist(), q_lens.tolist(), seq_lens.tolist()
    for b in range(len(ql)):
        if ql[b] <= 0 or sl[b] <= 0:
            continue
        slots = _row_slots(page_table[b], sl[b], page_size, S // page_size)
        q_pos = torch.arange(sl[b] - ql[b], sl[b])
        out[st[b]:st[b] + ql[b]] = _attend(q[st[b]:st[b] + ql[b]],
                                           cache[layer, slots], q_pos, n_kv,
                                           sm_scale)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def paged_decode_attention(q, cache, kv_new, page_table, q_lens, seq_lens,
                           kv_slots, layer: int, *, page_size: int,
                           sm_scale: float):
    """Decode attention with the KV write fused in.

    q [T, n_q, hd], cache [L, S, W] (updated in place), kv_new [T, W],
    page_table i32[B, Pg], q_lens/seq_lens i32[B], kv_slots i32[T>=B].
    Returns out [T, n_q, hd]: row b's attention for every valid row
    (q_lens[b] > 0, flat token b), zeros elsewhere."""
    args = (q, cache, kv_new, page_table, q_lens, seq_lens, kv_slots)
    if _on_cpu(*args):
        return paged_decode_attention_plain(
            *args, layer, page_size=page_size, sm_scale=sm_scale)
    _check_types((q, cache, kv_new), (page_table, q_lens, seq_lens, kv_slots))
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    _, S, W = cache.shape
    n_kv = W // (2 * hd)
    if T < B or kv_new.shape != (T, W) or 2 * n_kv * hd != W:
        raise ValueError(f"decode shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(cache.shape)}, kv_new {tuple(kv_new.shape)}, "
                         f"page_table {tuple(page_table.shape)}")
    out = torch.empty_like(q)
    err = build.entry("paged_decode_attention")(
        q.data_ptr(), cache.data_ptr(), kv_new.data_ptr(),
        page_table.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        kv_slots.data_ptr(), out.data_ptr(), T, B, Pg, n_q, n_kv, hd, S,
        int(layer), page_size, float(sm_scale), build.stream())
    build.check_launch("paged_decode_attention", err, _HINT)
    return out


def store_kv(cache, kv_new, kv_slots, layer: int) -> None:
    """cache[layer, kv_slots[t]] = kv_new[t] for every in-range slot, in
    place. cache [L, S, W], kv_new [T, W], kv_slots i32[T]."""
    if _on_cpu(cache, kv_new, kv_slots):
        store_kv_plain(cache, kv_new, kv_slots, layer)
        return
    _check_types((cache, kv_new), (kv_slots,))
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
                            layer: int, *, page_size: int, sm_scale: float,
                            q_bucket: int):
    """Causal attention of multi-token rows over the cache (their new KV is
    already stored). q [T, n_q, hd]; q_bucket bounds every q_lens[b].
    Returns out [T, n_q, hd], zeros at tokens of no row."""
    args = (q, cache, page_table, q_starts, q_lens, seq_lens)
    if _on_cpu(*args):
        return paged_prefill_attention_plain(
            *args, layer, page_size=page_size, sm_scale=sm_scale)
    _check_types((q, cache), (page_table, q_starts, q_lens, seq_lens))
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    _, S, W = cache.shape
    n_kv = W // (2 * hd)
    if 2 * n_kv * hd != W:
        raise ValueError(f"cache lanes {W} != 2*n_kv*hd")
    out = torch.zeros_like(q)
    err = build.entry("paged_prefill_attention")(
        q.data_ptr(), cache.data_ptr(), page_table.data_ptr(),
        q_starts.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, int(q_bucket), Pg, n_q, n_kv, hd, S, int(layer),
        page_size, float(sm_scale), build.stream())
    build.check_launch("paged_prefill_attention", err, _HINT)
    return out
