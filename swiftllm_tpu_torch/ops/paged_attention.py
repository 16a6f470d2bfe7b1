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

Split-KV (``csrc/splitkv.cuh``): the decode and prefill kernels cut each
attention unit's keys (a decode row's kv head; a prefill row's query tile
and kv head) into ``n_split`` splits of ``chunk`` keys, split s holding
positions ``[s * chunk, (s + 1) * chunk)`` and the last one running on to the
row's end, walked by separate blocks and merged by the last block to finish.
``split_plan`` chooses (n_split, chunk) from host integers alone (shapes,
the card's SM count and ``live_rows``, the bound on the rows with queries
that the batch builder knows), so a wrapper never reads a device value on
the host; ``split_kv_attention_plain`` is the plain version of that
split-then-merge. The bf16-score variant never splits. ``step_plans`` gives
a whole step's plans from its bucket and ``live_rows``, the same planners'
answers, and ``plan_rows`` the most rows that keep them: a CUDA graph of
the step is keyed by the plans and captured over those rows
(``worker/graphs.py``).

Each wrapper takes its plain version for tensors on the CPU, and only then.
On a CUDA tensor it launches its kernel or raises; it never falls back. The
kernels are built and bound by ``ops/build.py`` (``nvcc`` at first use,
``ctypes``), launched by ``build.launch`` on the current stream of the
tensors' card with that card current, and never synchronise. Every launch
adds one to ``build.launch_counts[name]``.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import torch

from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.utils import cdiv

# The C entries every serving step of this module's path can launch (sources
# in build.SOURCES). The deferred-commit and bf16-score variants run only
# when their environment variable asks for them.
KERNELS = ("paged_decode_attention", "store_kv", "paged_prefill_attention")

FP8 = torch.float8_e4m3fn
FP8_SCALE_LANES = 128   # lanes appended to an fp8 cache row (see above)

_HINT = " (an unsupported head_dim / GQA group returns 1)"

# GQA groups the kernels take: every group from 1 to MAX_GROUP, each run
# under the least of GROUP_BOUNDS at or above it (csrc/common.cuh:gqa_bound).
GROUP_BOUNDS = (1, 2, 4, 8)
MAX_GROUP = GROUP_BOUNDS[-1]
HEAD_DIMS = (64, 128)

# Split-KV plan (csrc/splitkv.cuh): at most MAX_SPLITS splits a unit (the
# kernels' kMaxSplits); the planner aims at SPLIT_BLOCKS_PER_SM blocks per SM
# over the grid, in chunks that are whole key tiles and not below a floor.
MAX_SPLITS = 32
SPLIT_BLOCKS_PER_SM = 4
KEY_TILE = 64                 # keys of a prefill key tile (paged_prefill.cu)
DECODE_KEY_STEP = 16          # decode chunks: any multiple of this
DECODE_MIN_CHUNK = 256
PREFILL_MIN_CHUNK = 128
# Rows a prefill launch takes: its blocks stage 16 bytes of every row in
# shared memory (paged_prefill.cu), beside at most 99 KiB of tiles.
PREFILL_MAX_ROWS = 8192


def max_pages_cap(page_size: int) -> int:
    """Largest pages-per-seq bucket the kernels take. They read the page table
    from device memory, so nothing caps it but the int32 token positions they
    index with (the JAX kernels' scalar-memory caps have no counterpart). It
    lies far above any pool a card holds, so in practice the pool binds."""
    return (2**31 - 1) // page_size


def split_plan(units: int, max_keys: int, n_sms: int, *, tile: int,
               min_chunk: int, splits: int | None = None,
               visible: int | None = None) -> tuple[int, int]:
    """(n_split, chunk) for a grid of ``units`` attention units whose rows
    hold at most ``max_keys`` keys, on a card of ``n_sms`` SMs: split s holds
    key positions [s * chunk, (s + 1) * chunk), the last split runs on to the
    row's end, so every key of every row lies in exactly one split. chunk is
    a multiple of ``tile``; the splits aim at SPLIT_BLOCKS_PER_SM blocks per
    SM, with no more of them than ``visible`` (the most keys a unit sees: a
    window's span; default max_keys) fills at ``min_chunk`` keys a split
    (one split when the units already fill the card), and at most
    MAX_SPLITS. ``splits`` forces the count (capped by MAX_SPLITS and the
    tiles of max_keys only). Ints only, by design: no device tensor reaches
    the plan, so no launch waits on a read of one (and a CUDA graph can hold
    it)."""
    for name, v in (("units", units), ("max_keys", max_keys), ("n_sms", n_sms),
                    ("tile", tile), ("min_chunk", min_chunk),
                    ("splits", 0 if splits is None else splits),
                    ("visible", 0 if visible is None else visible)):
        if type(v) is not int:
            raise TypeError(f"split_plan takes ints, got {name}={v!r}")
    max_keys = max(max_keys, 1)
    if splits is None:
        seen = max_keys if visible is None else min(max(visible, 1), max_keys)
        splits = min(cdiv(SPLIT_BLOCKS_PER_SM * n_sms, max(units, 1)),
                     cdiv(seen, min_chunk))
    splits = max(1, min(splits, MAX_SPLITS, cdiv(max_keys, tile)))
    chunk = cdiv(cdiv(max_keys, splits), tile) * tile
    return cdiv(max_keys, chunk), chunk


def split_range(s: int, n_split: int, chunk: int, lo: int,
                hi: int) -> tuple[int, int]:
    """Keys [beg, end) that split s walks in a unit whose visible keys are
    [lo, hi), as the kernels cut them (csrc/splitkv.cuh:split_keys); an
    empty range (beg == end) for a split the unit does not reach."""
    beg = max(lo, s * chunk)
    end = hi if s == n_split - 1 else min(hi, (s + 1) * chunk)
    return beg, max(beg, end)


def split_rows(B: int, live_rows: int | None) -> int:
    """The rows a launch plans its splits over: the ``B`` rows of the page
    table, or fewer when the caller knows that rows from ``live_rows`` on
    have no query (the batch builder pins B to the rows bucket)."""
    return B if live_rows is None else max(1, min(int(live_rows), B))


def decode_split_plan(B: int, n_kv: int, Pg: int, page_size: int, n_sms: int,
                      splits: int | None = None,
                      window: int = 0) -> tuple[int, int]:
    """The decode kernels' plan: units (row, kv head) over ``B`` rows (the
    rows that may have a query: ``split_rows``), rows of at most
    Pg * page_size keys, of which a query sees ``window`` (0: all)."""
    return split_plan(B * n_kv, Pg * page_size, n_sms, tile=DECODE_KEY_STEP,
                      min_chunk=DECODE_MIN_CHUNK, splits=splits,
                      visible=window or None)


def group_bound(group: int) -> int:
    """The GQA group bound a kernel runs a group under: the least of
    GROUP_BOUNDS at or above it (the kernels take the real group as an
    argument; csrc/common.cuh:gqa_bound). A group above MAX_GROUP gets the
    next power of two, which the plans can count but no kernel takes
    (``check_attention_shape`` refuses it at start-up)."""
    return 1 << max(group - 1, 0).bit_length()


def check_attention_shape(n_q: int, n_kv: int, hd: int) -> None:
    """Refuse an attention shape the kernels cannot take: head_dim not in
    HEAD_DIMS, or a GQA group n_q / n_kv that is not a whole number from 1
    to MAX_GROUP. Raises ``ValueError`` naming n_q, n_kv, head_dim and the
    group."""
    group = n_q / n_kv if n_kv > 0 else float("inf")
    if (hd not in HEAD_DIMS or n_kv < 1 or n_q % n_kv
            or not 1 <= group <= MAX_GROUP):
        raise ValueError(
            f"attention shape n_q {n_q}, n_kv {n_kv}, head_dim {hd} (GQA group "
            f"{group:g}): the attention kernels take head_dim in {HEAD_DIMS} "
            f"and a whole GQA group from 1 to {MAX_GROUP}")


def prefill_rows(q_bucket: int, group: int, hd: int) -> int:
    """Query rows (group bound x tokens) of a prefill block: 128, two
    warpgroups, at head_dim 128 when the bucket fills them, else 64
    (paged_prefill.cu:launch, the same rule)."""
    return 128 if hd == 128 and q_bucket * group_bound(group) >= 128 else 64


def prefill_tokens(q_bucket: int, group: int, hd: int) -> int:
    """Query tokens of a prefill tile: prefill_rows / group_bound. Its
    rows are group_bound bands of that many tokens, one a query head of
    the kv head (row g * tokens + token); the bands from ``group`` on are
    dead (paged_prefill.cu)."""
    return max(prefill_rows(q_bucket, group, hd) // group_bound(group), 1)


def prefill_split_plan(B: int, q_bucket: int, group: int, n_kv: int, Pg: int,
                       page_size: int, n_sms: int, splits: int | None = None,
                       window: int = 0, *, hd: int) -> tuple[int, int]:
    """The prefill kernel's plan: units (row, query tile of
    ``prefill_tokens`` tokens, kv head) over ``B`` rows (as in
    decode_split_plan); under a window a tile's queries see
    window + tokens - 1 keys."""
    tokens = prefill_tokens(q_bucket, group, hd)
    visible = window + tokens - 1 if window else None
    return split_plan(B * cdiv(q_bucket, tokens) * n_kv, Pg * page_size, n_sms,
                      tile=KEY_TILE, min_chunk=PREFILL_MIN_CHUNK,
                      splits=splits, visible=visible)


def prefill_units(B: int, q_bucket: int, group: int, n_kv: int,
                  hd: int) -> int:
    """Attention units of a prefill launch over ``B`` rows: (row, query
    tile of ``prefill_tokens`` tokens, kv head)."""
    return B * cdiv(q_bucket, prefill_tokens(q_bucket, group, hd)) * n_kv


class StepPlans(NamedTuple):
    """A step's attention plans, (n_split, chunk) each: the decode kernel's
    (its deferred-commit variant's too) and the prefill kernel's, None for a
    step that launches no prefill kernel (q bucket 1)."""
    decode: tuple[int, int]
    prefill: tuple[int, int] | None


@functools.lru_cache(maxsize=4096)
def step_plans(key, live_rows: int, *, n_q: int, n_kv: int, hd: int,
               page_size: int, window: int, n_sms: int) -> StepPlans:
    """The plans the wrappers choose for every launch of one step of bucket
    ``key`` (``rows``, ``pages`` and ``q_len`` are read) whose rows from
    ``live_rows`` on have no query, at a shard's ``n_q`` / ``n_kv`` heads of
    ``hd`` on a card of ``n_sms`` SMs (0 on the CPU, whose plain versions
    never split: every plan is one split). The same planners, the same
    arguments: ``paged_decode_attention`` (and ``_pend``) and
    ``paged_prefill_attention`` launch these plans. Ints only, cached."""
    R = split_rows(key.rows, live_rows)
    decode = decode_split_plan(R, n_kv, key.pages, page_size, n_sms,
                               window=window)
    prefill = None
    if key.q_len > 1:
        prefill = prefill_split_plan(R, key.q_len, n_q // n_kv, n_kv,
                                     key.pages, page_size, n_sms,
                                     window=window, hd=hd)
    return StepPlans(decode, prefill)


@functools.lru_cache(maxsize=4096)
def plan_rows(key, live_rows: int, **widths) -> int:
    """The most rows (at most ``key.rows``) a step of ``key`` can plan over
    and keep the plans of ``live_rows`` (``step_plans``' keyword arguments
    in ``widths``). The split counts only fall as rows grow, so these rows
    are an interval from ``live_rows`` up. A launch over them splits every
    live row as a launch over ``live_rows`` does, so its outputs are the
    same; the rows past ``live_rows`` have no query."""
    want = step_plans(key, live_rows, **widths)
    R = split_rows(key.rows, live_rows)
    while R < key.rows and step_plans(key, R + 1, **widths) == want:
        R += 1
    return R


def max_split_units(rows: int, max_q: int, *, n_q: int, n_kv: int,
                    hd: int) -> int:
    """The most attention units any launch of a bucket of at most ``rows``
    rows and q bucket ``max_q`` can plan: what the counters
    (``build.device_counters``) must hold, less the prefill kernel's two
    work-queue counters."""
    units, q = rows * n_kv, 2
    while q <= max(max_q, 2):
        units = max(units, prefill_units(rows, q, n_q // n_kv, n_kv, hd))
        q *= 2
    return units


def _split_buffers(device: torch.device, units: int, n_split: int, rows: int,
                   hd: int) -> list:
    """(part_acc, part_ml, counters) for a launch with n_split splits of
    ``units`` units of ``rows`` query rows: the partial states' scratch
    (f32, uninitialised; a split writes before the merge reads; None when
    nothing splits) and the device's counters (``build.device_counters``),
    ``units`` arrival counters and two for the prefill kernel's work queue,
    which every launch leaves zero (the merging block resets its own, the
    last block out the queue). The caller holds them until the launch is
    queued (``_ptrs``)."""
    bufs = [None, None]
    if n_split > 1:
        bufs = [torch.empty(units * n_split * rows * hd, dtype=torch.float32,
                            device=device),
                torch.empty(units * n_split * rows * 2, dtype=torch.float32,
                            device=device)]
    return bufs + [build.device_counters("paged_attention", device, units + 2)]


def _ptrs(tensors) -> list:
    return [None if t is None else t.data_ptr() for t in tensors]


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


def _bf16_of_exact(x64: torch.Tensor) -> torch.Tensor:
    """f64 values (exact dot products of bf16 vectors) rounded once to bf16,
    as f32: through f32, with an f32 that lands exactly on a bf16 rounding
    midpoint while the f64 value does not moved one f32 step toward it, so
    that the second rounding goes the way the exact value does."""
    x32 = x64.float()
    mid = (x32.view(torch.int32) & 0xFFFF) == 0x8000
    off = x32.double() != x64
    toward = torch.where(x64 > x32.double(), math.inf, -math.inf).float()
    x32 = torch.where(mid & off, torch.nextafter(x32, toward), x32)
    return _round_bf16(x32)


def _attend(q: torch.Tensor, kv: torch.Tensor, q_pos: torch.Tensor,
            n_kv: int, sm_scale: float, window: int,
            bf16_scores: bool = False, split=None) -> torch.Tensor:
    """q [n, n_q, hd] over one row's keys kv [K, W] (key k at position k; an
    fp8 row is un-scaled by its own lanes), causal by q_pos [n] and within
    ``window`` of it; f32 scores and softmax, output in q's dtype.

    ``split`` = (n_split, chunk): the kernels' split-then-merge, with their
    partition of the keys (split s: positions [s * chunk, (s + 1) * chunk),
    the last to the end): each split's own maximum m_s, sum l_s and
    accumulator over its visible keys, merged with weights exp(m_s - M); a
    split with no visible key of a query has weight 0 for it.

    ``bf16_scores``: the bf16-score variant's rounding, in log2 space, with
    the row's maximum over all its visible keys (the kernel's running
    maximum moves tile by tile, so the two round the exponent argument
    against different m): raw scores to bf16, rounded from their exact
    value (``_bf16_of_exact``), as the kernel rounds them; the argument
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
        # K2E as the kernel forms it: the f32 product of f32 operands.
        k2e = float(torch.tensor(sm_scale, dtype=torch.float32)
                    * torch.tensor(math.log2(math.e), dtype=torch.float32))
        k2e_b = float(torch.tensor(k2e).bfloat16())
        s = _bf16_of_exact(torch.einsum("nhgd,khd->hgnk", qf.double(), k.double()))
        m = s.masked_fill(~visible, float("-inf")).amax(-1, keepdim=True) * k2e
        arg = _round_bf16(_round_bf16(s * k2e_b) - _round_bf16(m))
        p = _round_bf16(torch.exp2(arg)) * visible
        o = torch.einsum("hgnk,khd->nhgd", p, v) / p.sum(-1).permute(2, 0, 1)[..., None]
        return o.reshape(n, n_q, hd).to(q.dtype)
    if split is None:
        p = torch.softmax((s * sm_scale).masked_fill(~visible, float("-inf")), dim=-1)
        return torch.einsum("hgnk,khd->nhgd", p, v).reshape(n, n_q, hd).to(q.dtype)
    logits = (s * sm_scale).masked_fill(~visible, float("-inf"))
    parts = []
    for j in range(split[0]):
        beg, end = split_range(j, *split, 0, K)
        if beg == end:
            continue
        lj = logits[..., beg:end]
        mj = lj.amax(-1, keepdim=True)                  # -inf: no visible key
        pj = torch.exp(lj - torch.where(torch.isinf(mj), 0.0, mj))
        parts.append((mj, pj.sum(-1, keepdim=True),
                      torch.einsum("hgnk,khd->hgnd", pj, v[beg:end])))
    M = torch.stack([mj for mj, _, _ in parts]).amax(0)
    num = den = 0.0
    for mj, lj, aj in parts:
        w = torch.exp(mj - M)                  # 0 where the split saw no key
        num = num + w * aj
        den = den + w * lj
    return (num / den).permute(2, 0, 1, 3).reshape(n, n_q, hd).to(q.dtype)


def bf16_scores_env() -> bool:
    """``SWIFTLLM_TILE_BF16_SCORES=1`` (off by default, as in the JAX
    package)."""
    return os.environ.get("SWIFTLLM_TILE_BF16_SCORES", "0") == "1"


def bf16_scores_on(cache: torch.Tensor, window: int,
                   asked: bool | None = None) -> bool:
    """Whether a multi-token attention call takes the bf16-score variant:
    ``asked`` (default: ``bf16_scores_env()``, read at each call), a cache
    that is not fp8, and no window. An fp8 or a windowed call keeps f32
    scores, as the JAX gate does."""
    if asked is None:
        asked = bf16_scores_env()
    return asked and cache.dtype != FP8 and not window


def paged_decode_attention_plain(q, cache, kv_new, page_table, q_lens,
                                 seq_lens, kv_slots, layer: int, *, n_kv: int,
                                 page_size: int, sm_scale: float,
                                 window: int = 0, split=None):
    """Plain version of ``paged_decode_attention``: the same writes to
    ``cache`` (in place) and the same output. The new token's key is read
    from ``kv_new`` as stored (quantized, with an fp8 cache). ``split``
    (n_split, chunk): computed split by split, as the kernel splits."""
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
                               n_kv, sm_scale, window, split=split)
    return out


def paged_decode_attention_pend_plain(q, cache, kv_new, kv_pend, page_table,
                                      q_lens, seq_lens, layer: int, *,
                                      npend: int, n_kv: int, page_size: int,
                                      sm_scale: float, window: int = 0,
                                      split=None):
    """Plain version of ``paged_decode_attention_pend``: each row's cached
    keys gathered from its pages, its live pending rows and its new row
    appended. The cache is only read. ``split`` as for the decode one."""
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
                               n_kv, sm_scale, window, split=split)
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
                                  window: int = 0, bf16_scores: bool = False,
                                  split=None):
    """Plain version of ``paged_prefill_attention`` (and, with
    ``bf16_scores``, of its bf16-score variant, which never splits). Tokens
    of no row are 0. ``split`` (n_split, chunk): computed split by split."""
    if split is not None and bf16_scores:
        raise ValueError("the bf16-score variant never splits its keys")
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
            q_pos, n_kv, sm_scale, window, bf16_scores, split)
    return out


SPLIT_PLAIN = {"paged_decode_attention": paged_decode_attention_plain,
               "paged_decode_attention_pend": paged_decode_attention_pend_plain,
               "paged_prefill_attention": paged_prefill_attention_plain}


def split_kv_attention_plain(kind: str, *args, split: tuple[int, int], **kw):
    """The plain version of split-then-merge: kernel ``kind``'s plain
    version (a key of SPLIT_PLAIN, with its arguments) with each row's keys
    cut as the kernel cuts them under the plan ``split`` = (n_split, chunk),
    every split's softmax state computed alone and the states merged. Equal
    to the unsplit plain version up to f32 rounding."""
    return SPLIT_PLAIN[kind](*args, split=split, **kw)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def paged_decode_attention(q, cache, kv_new, page_table, q_lens, seq_lens,
                           kv_slots, layer: int, *, n_kv: int, page_size: int,
                           sm_scale: float, window: int = 0,
                           splits: int | None = None,
                           live_rows: int | None = None):
    """Decode attention with the KV write fused in.

    q [T, n_q, hd], cache [L, S, W] (updated in place), kv_new [T, W] in the
    cache's dtype, page_table i32[B, Pg], q_lens/seq_lens i32[B], kv_slots
    i32[T>=B]. Returns out [T, n_q, hd]: row b's attention for every valid
    row (q_lens[b] > 0, flat token b), zeros elsewhere. ``live_rows``: rows
    from it on have no query, as the caller knows on the host (the split
    plan counts only the rows below it; a valid row past it is computed all
    the same, unsplit). ``splits`` forces the split count of the kernel
    (decode_split_plan's choice when None). On CPU tensors the plain
    version runs, unsplit."""
    args = (q, cache, kv_new, page_table, q_lens, seq_lens, kv_slots)
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    if _on_cpu(*args):
        return paged_decode_attention_plain(
            *args, layer, n_kv=n_kv, page_size=page_size, sm_scale=sm_scale,
            window=window)
    _check_types((q,), (cache, kv_new),
                 (page_table, q_lens, seq_lens, kv_slots))
    _, S, W = cache.shape
    scale_lanes(cache, n_kv, hd)
    if T < B or kv_new.shape != (T, W) or window < 0:
        raise ValueError(f"decode shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(cache.shape)}, kv_new {tuple(kv_new.shape)}, "
                         f"page_table {tuple(page_table.shape)}, window {window}")
    R = split_rows(B, live_rows)
    n_split, chunk = decode_split_plan(R, n_kv, Pg, page_size,
                                       build.sm_count(q.device), splits, window)
    bufs = _split_buffers(q.device, R * n_kv, n_split, n_q // n_kv, hd)
    out = torch.empty_like(q)
    build.launch(
        "paged_decode_attention", q.device,
        q.data_ptr(), cache.data_ptr(), kv_new.data_ptr(),
        page_table.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        kv_slots.data_ptr(), out.data_ptr(), T, B, Pg, n_q, n_kv, hd, S,
        int(layer), page_size, int(window), int(cache.dtype == FP8),
        float(sm_scale), n_split, chunk, R, *_ptrs(bufs), hint=_HINT)
    return out


def paged_decode_attention_pend(q, cache, kv_new, kv_pend, page_table, q_lens,
                                seq_lens, layer: int, *, npend: int,
                                n_kv: int, page_size: int, sm_scale: float,
                                window: int = 0, splits: int | None = None,
                                live_rows: int | None = None):
    """Decode attention in deferred-commit mode: no cache write.

    q [T, n_q, hd], cache [L, S, W] bf16 (read only), kv_new [T, W], kv_pend
    [L, P, B, W] in the cache's dtype, page_table i32[B, Pg], q_lens/seq_lens
    i32[B]; ``npend`` in 1..P is the same for every row (inner step
    ``npend - 1`` of the window). Key ``pos`` of row b comes from the pages
    for ``pos < hist = max(seq_lens[b] - npend, 0)``, from
    ``kv_pend[layer, pos - hist, b]`` for ``hist <= pos < seq_lens[b] - 1``
    and from ``kv_new[b]`` for the last. Pending slots from ``npend - 1`` on
    are never read. Returns out [T, n_q, hd], zeros at rows that are not
    valid. ``splits`` and ``live_rows`` as for ``paged_decode_attention``."""
    args = (q, cache, kv_new, kv_pend, page_table, q_lens, seq_lens)
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    if _on_cpu(*args):
        return paged_decode_attention_pend_plain(
            *args, layer, npend=npend, n_kv=n_kv, page_size=page_size,
            sm_scale=sm_scale, window=window)
    _check_types((q,), (cache, kv_new, kv_pend),
                 (page_table, q_lens, seq_lens))
    _, S, W = cache.shape
    _check_pend(cache, kv_new, kv_pend, npend, n_kv, hd, B)
    if T < B or kv_new.shape != (T, W) or window < 0:
        raise ValueError(f"decode shapes: q {tuple(q.shape)}, kv_new "
                         f"{tuple(kv_new.shape)}, page_table "
                         f"{tuple(page_table.shape)}, window {window}")
    R = split_rows(B, live_rows)
    n_split, chunk = decode_split_plan(R, n_kv, Pg, page_size,
                                       build.sm_count(q.device), splits, window)
    bufs = _split_buffers(q.device, R * n_kv, n_split, n_q // n_kv, hd)
    out = torch.empty_like(q)
    build.launch(
        "paged_decode_attention_pend", q.device,
        q.data_ptr(), cache.data_ptr(), kv_new.data_ptr(), kv_pend.data_ptr(),
        page_table.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), T, B, Pg, n_q, n_kv, hd, S, int(layer), page_size,
        int(window), int(npend), kv_pend.shape[1], float(sm_scale), n_split,
        chunk, R, *_ptrs(bufs), hint=_HINT)
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
    build.launch("store_kv", cache.device, kv_new.data_ptr(), cache.data_ptr(),
                 kv_slots.data_ptr(), T, row_bytes, cache.shape[1], int(layer),
                 hint=_HINT)


def paged_prefill_attention(q, cache, page_table, q_starts, q_lens, seq_lens,
                            layer: int, *, n_kv: int, page_size: int,
                            sm_scale: float, q_bucket: int, window: int = 0,
                            splits: int | None = None,
                            live_rows: int | None = None,
                            bf16_scores: bool | None = None):
    """Causal attention of multi-token rows over the cache (their new KV is
    already stored). q [T, n_q, hd]; q_bucket bounds every q_lens[b]; at
    most PREFILL_MAX_ROWS rows. Returns out [T, n_q, hd], zeros at tokens
    of no row.

    A row's span may start and end anywhere in a page: row b's queries are
    flat tokens q_starts[b] .. q_starts[b] + q_lens[b] - 1 at positions
    seq_lens[b] - q_lens[b] .. seq_lens[b] - 1, with no alignment of either.
    A speculative verify step ([next token] + drafts, q_bucket =
    next_pow2(spec_k + 1)) relies on it, and on this: no key at or past
    seq_lens[b] is read, so slots that still hold rejected drafts of an
    earlier step are invisible once seq_lens[b] stops short of them.

    With ``bf16_scores_on`` (``bf16_scores``, by default
    ``SWIFTLLM_TILE_BF16_SCORES=1``; a cache that is not fp8, no window) it
    launches ``paged_prefill_attention_bf16s``, whose
    launches count under that name, and which never splits. ``splits``
    forces the split count of the f32 kernel (prefill_split_plan's choice
    when None) and ``live_rows`` bounds the rows it plans over, as for
    ``paged_decode_attention``. On CPU tensors the plain version runs,
    unsplit."""
    args = (q, cache, page_table, q_starts, q_lens, seq_lens)
    bf16s = bf16_scores_on(cache, window, bf16_scores)
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    if _on_cpu(*args):
        return paged_prefill_attention_plain(
            *args, layer, n_kv=n_kv, page_size=page_size, sm_scale=sm_scale,
            window=window, bf16_scores=bf16s)
    _check_types((q,), (cache,), (page_table, q_starts, q_lens, seq_lens))
    S = cache.shape[1]
    scale_lanes(cache, n_kv, hd)
    if window < 0 or B > PREFILL_MAX_ROWS:
        raise ValueError(f"prefill: window {window}, {B} rows (at most "
                         f"{PREFILL_MAX_ROWS})")
    if bf16s:
        out = torch.zeros_like(q)
        build.launch(
            "paged_prefill_attention_bf16s", q.device,
            q.data_ptr(), cache.data_ptr(), page_table.data_ptr(),
            q_starts.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), B, int(q_bucket), Pg, n_q, n_kv, hd, S,
            int(layer), page_size, float(sm_scale), hint=_HINT)
        return out
    group = n_q // n_kv
    R = split_rows(B, live_rows)
    n_split, chunk = prefill_split_plan(R, int(q_bucket), group, n_kv, Pg,
                                        page_size, build.sm_count(q.device), splits,
                                        int(window), hd=hd)
    rows = prefill_rows(int(q_bucket), group, hd)
    units = prefill_units(R, int(q_bucket), group, n_kv, hd)
    bufs = _split_buffers(q.device, units, n_split, rows, hd)
    out = torch.empty_like(q)          # the kernel zeroes tokens of no row
    build.launch(
        "paged_prefill_attention", q.device,
        q.data_ptr(), cache.data_ptr(), page_table.data_ptr(),
        q_starts.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, int(q_bucket), Pg, n_q, n_kv, hd, S, int(layer),
        page_size, int(window), int(cache.dtype == FP8), float(sm_scale),
        n_split, chunk, R, *_ptrs(bufs), T, hint=_HINT)
    return out
