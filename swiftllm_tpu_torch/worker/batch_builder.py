"""Host-side batch builder: ScheduledSeqs → a padded, static-shape StepBatch.

This is the host half of the data plane, a port of
``swiftllm_tpu/worker/batch_builder.py`` that packs the same bytes. Every
array is padded to a bucket (the JAX package compiles one program per bucket;
the port keeps the buckets so both packages pack identical buffers). The
builder also performs page allocation (via the host BlockManager) and
computes each token's flat KV-slot destination.

dp support: sequences are pre-partitioned into ``dp`` groups (one BlockManager
per group, each owning its own page pool). Group g's arrays occupy the g-th
equal slice of every batch axis, matching the "dp"-sharded NamedShardings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from swiftllm_tpu_torch.config import EngineConfig
from swiftllm_tpu_torch.models.llama import StepBatch
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.utils import cdiv, next_power_of_2, tile_q_for
from swiftllm_tpu_torch.worker.block_manager import BlockManager


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Static signature of one compiled step program (shapes + variant)."""
    tokens: int      # T_local (per dp shard)
    rows: int        # B_local
    pages: int       # P (pages-per-seq axis)
    q_len: int       # Q (max new tokens per row)
    sampling: int = 0  # 1 → temperature/top-k/top-p sampler needed;
                       # 0 → greedy-only head
    spec: int = 0      # >0 → speculative-verify step: the sampling head reads
                       # EVERY span position (S1 = this value = q_len) instead
                       # of each row's last token; tokens come out [B*S1]
    steps: int = 1     # >1 → multi-step decode: S decode steps scanned inside
                       # one program (pure-decode batches only); tokens come
                       # out [B*S] row-major. Amortizes per-dispatch overhead.


def _pick_bucket(buckets: tuple[int, ...], needed: int, hard: bool = False) -> int:
    for b in buckets:
        if b >= needed:
            return b
    if hard:
        raise RuntimeError(f"needed {needed} exceeds largest bucket {buckets[-1]}")
    return next_power_of_2(needed)


def select_buckets(groups: list[list[ScheduledSeq]], cfg: EngineConfig,
                   multi_step: int = 1) -> BucketKey:
    """Decode-kind rows (n_tokens == 1) pack densely; prefill rows tile-align."""
    max_rows = max(len(g) for g in groups)
    max_q = max((s.n_tokens for g in groups for s in g), default=1)
    spec = any(s.drafts for g in groups for s in g)
    if multi_step > 1:
        assert not spec and max_q == 1, \
            "multi_step requires a pure-decode batch (1 token per row)"
    if spec:
        # Speculative-verify step: q bucket PINNED to the configured span so
        # varying per-step draft counts reuse one compiled program. The
        # scheduler never mixes prefill chunks into a spec step.
        assert all(s.drafts or s.n_tokens == 1 for g in groups for s in g), \
            "spec steps must not contain prefill chunks"
        q_len = next_power_of_2(cfg.spec_k + 1)
        assert max_q <= q_len, f"span {max_q} > spec bucket {q_len}"
    # Pin the q bucket: 1 (decode-only) or at least the full prefill chunk —
    # tail chunks padding up beats a separate compiled program per tail size.
    # (Direct forward() callers may feed more than a chunk; take the max.)
    elif max_q == 1:
        q_len = 1
    else:
        q_len = next_power_of_2(
            max(max_q, min(cfg.prefill_chunk_size, cfg.max_tokens_in_batch)))
    align = tile_q_for(q_len)

    def group_tokens(g):
        n_dec = sum(1 for s in g if s.n_tokens == 1)
        pre = sum(cdiv(s.n_tokens, align) * align for s in g if s.n_tokens > 1)
        return cdiv(n_dec, align) * align + pre if pre else n_dec

    max_tokens = max(group_tokens(g) for g in groups)
    extra = multi_step - 1   # multi-step decode writes S tokens' KV per row
    max_pages = max((cdiv(s.request.num_cached_tokens + s.n_tokens + extra,
                          cfg.block_size)
                     for g in groups for s in g), default=1)
    # The ROWS bucket is pinned to max_batch_size (the JAX package pins it so
    # that row counts never trigger a compile; the port keeps the layout).
    rows_bucket = next_power_of_2(cfg.max_batch_size)
    # The PAGES bucket is pinned like rows, to the per-sequence maximum capped
    # by the kernels' own page cap; only contexts beyond the pinned bucket
    # fall back to a floating bucket.
    from swiftllm_tpu_torch.ops.paged_attention import max_pages_cap
    pages_pinned = min(_pick_bucket(cfg.page_buckets, cfg.max_blocks_per_seq),
                       max_pages_cap(cfg.block_size))
    pages = (pages_pinned if max_pages <= pages_pinned
             else _pick_bucket(cfg.page_buckets, max_pages, hard=True))
    # hard=True: tile padding must never silently compile an unplanned larger
    # program (the scheduler reserves per-chunk alignment in its token budget;
    # direct forward() callers get a clear error instead of a surprise bucket).
    return BucketKey(
        tokens=_pick_bucket(cfg.token_buckets, max(max_tokens, rows_bucket),
                            hard=True),
        rows=rows_bucket,
        pages=pages,
        q_len=q_len,
        sampling=int(any(s.request.temperature > 0
                         for g in groups for s in g)),
        spec=q_len if spec else 0,
        steps=max(multi_step, 1),
    )


def build_step_batch(
    groups: list[list[ScheduledSeq]],
    block_mgrs: list[BlockManager],
    cfg: EngineConfig,
    key: BucketKey | None = None,
    multi_step: int = 1,
) -> tuple[StepBatch, BucketKey, list[ScheduledSeq]]:
    """Allocate pages for every scheduled token and assemble the numpy StepBatch.

    Returns (batch, bucket_key, rows) where rows[i] is the ScheduledSeq whose
    sampled token is out_tokens[i] (global row order, group-major).

    ``multi_step`` S > 1 (pure-decode batches): pages are allocated for S
    tokens per row up front; the device program advances the batch between
    its S inner steps (models.llama.advance_decode_batch). Every live row
    must sample its own next token (asserted) — the feedback buffer is the
    only token source for inner steps 1..S-1.
    """
    assert len(groups) == len(block_mgrs)
    dp = len(groups)
    if key is None:
        key = select_buckets(groups, cfg, multi_step)
    ms_extra = key.steps - 1
    T, B, Pg, Q = key.tokens, key.rows, key.pages, key.q_len
    ps = cfg.block_size
    align = tile_q_for(Q)

    token_ids = np.zeros((dp, T), np.int32)
    positions = np.zeros((dp, T), np.int32)
    kv_slots = np.zeros((dp, T), np.int32)
    q_starts = np.full((dp, B), T, np.int32)
    q_lens = np.zeros((dp, B), np.int32)
    seq_lens = np.zeros((dp, B), np.int32)
    page_table = np.zeros((dp, B, Pg), np.int32)
    sample_mask = np.zeros((dp, B), bool)
    temperature = np.zeros((dp, B), np.float32)
    top_p = np.ones((dp, B), np.float32)
    top_k = np.zeros((dp, B), np.int32)
    seeds = np.zeros((dp, B), np.uint32)
    feedback_read = np.full((dp, T), -1, np.int32)
    garbage_fb_slot = cfg.max_seqs_in_block_table
    feedback_write = np.full((dp, B), garbage_fb_slot, np.int32)

    decode_row = np.zeros((dp, B), bool)
    kv_slots_scatter = np.zeros((dp, T), np.int32)
    lora_ids = np.zeros((dp, T), np.int32)

    rows: list[ScheduledSeq] = [None] * (dp * B)  # type: ignore

    def fill_decode_group(g: int, group, mgr):
        """Vectorized fast path for an all-decode group (the steady serving
        state): one list pass + a dozen vector ops instead of ~20 small numpy
        ops per row."""
        n = len(group)
        reqs = [s.request for s in group]
        seq_ids = np.fromiter((r.seq_id for r in reqs), np.int32, n)
        ends = np.fromiter((r.num_cached_tokens + 1 for r in reqs), np.int64, n)
        pos = ends - 1
        have = mgr.num_seq_allocated_blocks[seq_ids]
        need = (ends + ms_extra + ps - 1) // ps
        for i in np.nonzero(need > have)[0]:
            mgr.allocate_for_seq(int(seq_ids[i]), int(ends[i]) + ms_extra)
        assert int(need.max(initial=0)) <= Pg, \
            f"dp group {g}: {int(need.max())} pages > bucket {Pg}"
        pt = mgr.block_table[seq_ids, :Pg]                   # [n, Pg]
        page_table[g, :n, :] = pt
        # NOTE: columns beyond a row's allocated count hold stale table
        # entries; the kernels never DMA beyond cdiv(seq_len-1, ps) pages.
        kv_slots[g, :n] = pt[np.arange(n), pos // ps] * ps + pos % ps
        positions[g, :n] = pos
        q_starts[g, :n] = np.arange(n, dtype=np.int32)
        q_lens[g, :n] = 1
        seq_lens[g, :n] = ends
        decode_row[g, :n] = True
        toks = np.zeros(n, np.int32)
        for i, r in enumerate(reqs):
            idx = r.num_cached_tokens
            t = (r.output_token_ids[idx - r.prompt_len]
                 if idx >= r.prompt_len else r.prompt_token_ids[idx])
            if t is None:   # still on device: read from the feedback buffer
                feedback_read[g, i] = r.seq_id
            else:
                toks[i] = t
        token_ids[g, :n] = toks
        lora_ids[g, :n] = np.fromiter(
            (getattr(r, "lora_slot", 0) for r in reqs), np.int32, n)
        samples = np.fromiter((r.num_cached_tokens + 1 == r.total_len
                               for r in reqs), bool, n)
        assert ms_extra == 0 or samples.all(), \
            "multi-step rows must all sample (feedback is the token source)"
        sample_mask[g, :n] = samples
        feedback_write[g, :n] = np.where(samples, seq_ids, garbage_fb_slot)
        temperature[g, :n] = np.fromiter((r.temperature for r in reqs),
                                         np.float32, n)
        top_p[g, :n] = np.fromiter((r.top_p for r in reqs), np.float32, n)
        top_k[g, :n] = np.fromiter((r.top_k for r in reqs), np.int32, n)
        seeds[g, :n] = ((np.fromiter((r.sampling_seed for r in reqs),
                                     np.uint64, n) * np.uint64(2654435761)
                        + ends.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
                        ).astype(np.uint32)
        for i, s in enumerate(group):
            rows[g * B + i] = s

    for g, (group, mgr) in enumerate(zip(groups, block_mgrs)):
        assert len(group) <= B, f"dp group {g} has {len(group)} rows > bucket {B}"
        garbage_slot = mgr.num_blocks * ps
        kv_slots[g, :] = garbage_slot
        kv_slots_scatter[g, :] = garbage_slot
        if group and all(s.n_tokens == 1 for s in group):
            fill_decode_group(g, group, mgr)
            continue
        assert ms_extra == 0 or not group, \
            "multi-step batches must be pure decode (1 token per row)"
        # Decode-kind rows FIRST and packed densely so flat token == row index
        # (the fused decode kernel's contract); prefill spans follow,
        # tile-aligned for the tile kernel's DMAs.
        group = sorted(group, key=lambda s: s.n_tokens > 1)
        cursor = 0
        prev_was_decode = True
        for b, s in enumerate(group):
            if s.n_tokens > 1 and prev_was_decode:
                cursor = cdiv(cursor, align) * align if cursor else 0
                prev_was_decode = False
            r = s.request
            n = s.n_tokens
            start, end = r.num_cached_tokens, r.num_cached_tokens + n
            # (The JAX package asserts page-aligned span starts here for its
            # tile kernel's in-kernel write; the port's span write (in the
            # rope kernel) writes any slot, so it needs no such contract.)
            mgr.allocate_for_seq(r.seq_id, end)
            if mgr.prefix_caching and end <= r.prompt_len:
                # Prompt pages this chunk fills become matchable by requests
                # admitted at the NEXT scheduling round (never this step's).
                mgr.register_prefix(r.seq_id, r.prompt_token_ids, end,
                                    namespace=getattr(r, "lora_slot", 0))
            pages = mgr.seq_block_ids(r.seq_id)
            npages = len(pages)
            assert npages <= Pg, f"seq {r.seq_id} has {npages} pages > bucket {Pg}"

            if s.drafts:
                # Speculative verify span: [next real token] + host drafts
                # (drafts are NOT part of all_token_ids — only accepted ones
                # join it at resolve time, as the model's own outputs).
                fed = r.all_token_ids[start:start + 1] + list(s.drafts)
            else:
                fed = r.all_token_ids[start:end]
            if fed and fed[-1] is None:
                # The request's last sampled token is still on-device (async
                # pipelining): read it from the feedback buffer instead.
                fed = list(fed)
                fed[-1] = 0
                feedback_read[g, cursor + n - 1] = r.seq_id
            assert all(t is not None for t in fed), \
                f"seq {r.seq_id}: only the final sampled token may be unresolved"
            token_ids[g, cursor:cursor + n] = fed
            lora_ids[g, cursor:cursor + n] = getattr(r, "lora_slot", 0)
            pos = np.arange(start, end, dtype=np.int32)
            positions[g, cursor:cursor + n] = pos
            slots = pages[pos // ps] * ps + pos % ps
            kv_slots[g, cursor:cursor + n] = slots
            if n == 1:
                decode_row[g, b] = True   # fused kernel writes this KV
            else:
                kv_slots_scatter[g, cursor:cursor + n] = slots
            q_starts[g, b] = cursor
            q_lens[g, b] = n
            seq_lens[g, b] = end
            page_table[g, b, :npages] = pages
            sample_mask[g, b] = s.samples_token
            if s.samples_token:
                feedback_write[g, b] = r.seq_id
            temperature[g, b] = r.temperature
            top_p[g, b] = r.top_p
            top_k[g, b] = r.top_k
            # Per-(request, position) seed → deterministic replay, decorrelated rows.
            seeds[g, b] = np.uint32((np.uint64(r.sampling_seed) * np.uint64(2654435761)
                                     + np.uint64(end)) & np.uint64(0xFFFFFFFF))
            rows[g * B + b] = s
            cursor += n if n == 1 else cdiv(n, align) * align
        assert cursor <= T, f"dp group {g}: {cursor} tokens > bucket {T}"

    batch = StepBatch(
        token_ids=token_ids.reshape(dp * T),
        positions=positions.reshape(dp * T),
        kv_slots=kv_slots.reshape(dp * T),
        q_starts=q_starts.reshape(dp * B),
        q_lens=q_lens.reshape(dp * B),
        seq_lens=seq_lens.reshape(dp * B),
        page_table=page_table.reshape(dp * B, Pg),
        sample_mask=sample_mask.reshape(dp * B),
        temperature=temperature.reshape(dp * B),
        top_p=top_p.reshape(dp * B),
        top_k=top_k.reshape(dp * B),
        seeds=seeds.reshape(dp * B),
        feedback_read=feedback_read.reshape(dp * T),
        feedback_write=feedback_write.reshape(dp * B),
        decode_row=decode_row.reshape(dp * B),
        kv_slots_scatter=kv_slots_scatter.reshape(dp * T),
        lora_ids=lora_ids.reshape(dp * T),
    )
    return batch, key, rows


# Packed-buffer layout: ONE token-axis field (token_ids — the only per-token
# data the device cannot derive), 12 row-axis fields, and the [B, Pg] page
# table — see pack_step_batch below. positions / kv_slots / kv_slots_scatter
# / feedback_read / lora_ids are DERIVED ON DEVICE from the row fields
# (models.llama.unpack_step_batch), which keeps the host-to-device copy small.
# packed_len is THE single source of truth for the buffer length.
N_TOKEN_FIELDS = 1
N_ROW_FIELDS = 12


def packed_len(key: BucketKey, dp: int = 1) -> int:
    """Length of the flat i32 buffer pack_step_batch emits for this bucket."""
    return dp * (N_TOKEN_FIELDS * key.tokens + N_ROW_FIELDS * key.rows
                 + key.rows * key.pages)


def pack_step_batch(batch: StepBatch, dp: int) -> np.ndarray:
    """Flatten the StepBatch into ONE i32 buffer (f32 fields bitcast), laid out
    dp-major so a P("dp") sharding splits it per group.

    One host-to-device copy instead of 14 — and only the UNDERIVABLE fields:
    token_ids, the per-row arrays, and the page table. The step reconstructs
    the per-token fields from those (models.llama.unpack_step_batch).

    CONTRACT (builder-upheld): feedback_read may only be set (>= 0) at a
    row's LAST span token — the engine's async pipeline only ever defers the
    final sampled token — and lora_ids is constant within a row's span. Both
    therefore compress to [B] row fields on the wire."""
    T = batch.token_ids.shape[0] // dp
    B = batch.q_starts.shape[0] // dp

    def i32(x):
        a = np.asarray(x)
        if a.dtype == np.bool_:
            a = a.astype(np.int32)
        return a.reshape(dp, -1).view(np.int32)

    q_starts = np.asarray(batch.q_starts)
    q_lens = np.asarray(batch.q_lens)
    # q_starts are group-LOCAL (group g's tokens live at [g*T, (g+1)*T) in
    # the flat arrays); offset per group to index the flat [dp*T] fields.
    goff = np.repeat(np.arange(dp, dtype=np.int64) * T, B)
    flat_last = np.clip(goff + q_starts + q_lens - 1, 0, dp * T - 1)
    frd_row = np.where(q_lens > 0,
                       np.asarray(batch.feedback_read)[flat_last],
                       -1).astype(np.int32)
    flat_first = np.clip(goff + q_starts, 0, dp * T - 1)
    lora_row = np.where(q_lens > 0,
                        np.asarray(batch.lora_ids)[flat_first],
                        0).astype(np.int32)

    parts = [i32(batch.token_ids),
             i32(batch.q_starts), i32(batch.q_lens), i32(batch.seq_lens),
             i32(batch.sample_mask), i32(batch.temperature), i32(batch.top_p),
             i32(batch.top_k), i32(batch.seeds), i32(batch.feedback_write),
             i32(batch.decode_row), i32(frd_row), i32(lora_row),
             i32(batch.page_table)]
    return np.concatenate(parts, axis=1).reshape(-1)


def partition_for_dp(scheduled: list[ScheduledSeq], dp: int) -> list[list[ScheduledSeq]]:
    """Greedy token-balanced partition of a step's sequences into dp groups.

    NOTE: with dp>1 each sequence's pages must live in that group's pool, so
    the assignment must be sticky per request across steps. The engine pins a
    request to a dp group at admission (request.seq_id encodes the group via
    round-robin); this helper is for single-step/offline use.
    """
    if dp == 1:
        return [scheduled]
    groups: list[list[ScheduledSeq]] = [[] for _ in range(dp)]
    loads = [0] * dp
    for s in sorted(scheduled, key=lambda s: -s.n_tokens):
        g = loads.index(min(loads))
        groups[g].append(s)
        loads[g] += s.n_tokens
    return groups
