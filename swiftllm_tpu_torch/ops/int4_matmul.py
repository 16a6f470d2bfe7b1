"""Fused INT4 dequant-matmul for the PyTorch port: a CUDA kernel written by
hand for Hopper (sm_90a, ``csrc/int4_matmul.cu``), its plain PyTorch
versions (unsplit, and split-then-merge), its split plan, and its launch
counter.

Contract (the same as ``swiftllm_tpu/ops/int4_matmul.py:int4_proj_stacked``):
``y[T, N] = x[T, K] @ dequant(q4[layer])^T * s[layer]``, with q4 ``[L, N,
K/2]`` int8 split-half packed (byte j = column j in the low nibble, column
K/2 + j in the high nibble; see ``worker/quant.py``) and s ``[L, N]`` f32
per-output-channel scales. Up to 256 tokens the product accumulates in
f32, is multiplied by the scale, and is rounded to x's dtype ONCE (the TPU
kernel's numerics, not ``proj``'s two rounded half-products).

Above WIDE_ABOVE (256) tokens the kernel takes its wide configuration
(``csrc/wide_matmul.cuh``: tiles of 256 tokens, pairs of blocks sharing x),
and with it the arithmetic of the path the JAX package takes there,
``quant.proj``'s INT4 branch: a low-nibble product over x[:, :K/2] and a
high-nibble one over x[:, K/2:], each rounded to x's dtype, added there,
then scaled and rounded (``int4_proj_wide_plain``; its split-then-merge is
``int4_wide_split_plain``). Up to 256 tokens it keeps the TPU kernel's
single rounding, and so does a head of at most 256 rows.

The kernel reads the stacked weights at the layer's offset, as the TPU
kernel takes the layer by scalar prefetch: no per-layer slice is copied. It
takes any N, any even K (K/2 a multiple of 16 above 256 tokens, for TMA)
and any T > 0. It cuts K into chunks of packed bytes (``chunk_bytes``; 64
of one half at a time in the wide configuration) and may split the chunks
of a tile over several blocks; the last block of a tile to finish sums the
splits' f32 partials in split order (``int4_proj_split_plain`` is the plain
version of that). The wide configuration walks its last units stream-K
(``wide_work``): a unit cut between pairs of blocks is merged the same way,
its segments in K order (``int4_wide_split_plain``). The TPU kernel's tile
picking and sublane padding have no Hopper counterpart.

The wrapper takes the plain version for tensors on the CPU, and only then. On
a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.utils import cdiv
from swiftllm_tpu_torch.worker.quant import nibbles, proj

BM = 128                      # weight rows a tile (csrc/int4_matmul.cu:kBM)
TOKEN_WIDTHS = (16, 32, 64, 128)   # the narrow configuration's token tiles (NT)
WIDE_ABOVE = 256              # T above which the plans take the wide configuration
WIDE_NT = 256                 # its token tile (csrc/wide_matmul.cuh:kNT)
WIDE_KC = 64                  # its chunk: weight bytes, or packed bytes of a half
CLUSTER = 2                   # its blocks a cluster, on neighbouring weight tiles


def is_wide(T: int, nt: int | None) -> bool:
    """Whether a launch at T tokens (``nt`` forced, or None) takes the wide
    configuration."""
    return nt == WIDE_NT or (nt is None and T > WIDE_ABOVE)


def chunk_bytes(nt: int) -> int:
    """Packed bytes a K chunk at token width ``nt`` (Cfg<NT>::kKC)."""
    return 64 if nt == 128 else 128


class MatmulPlan(NamedTuple):
    """A launch's plan, ints only: ``t_tiles`` token tiles of ``nt``
    columns, ``tiles`` tiles of BM weight rows, ``chunks`` K chunks of
    ``kc`` packed bytes cut into ``splits`` splits of ``per`` (the last may
    be shorter), ``units`` = tiles x t_tiles x splits, on ``grid``
    persistent blocks. In the wide configuration (nt = WIDE_NT) a unit is a
    pair of tiles x a token tile over all ``chunks`` (both nibble halves),
    ``per`` of the ``units`` are walked whole and the rest stream-K
    (``wide_work``), and ``splits`` is the most segments a unit is cut
    into (1: none is cut); ``grid`` is even, pairs of blocks."""
    nt: int
    t_tiles: int
    tiles: int
    kc: int
    chunks: int
    splits: int
    per: int
    units: int
    grid: int


# The plan's model of a launch's time on an H100 (µs), fitted to the times
# of the (token width, splits) pairs at the four 8B shapes that
# `chip_smoke.py --sweep-int4` prints beside it: a fixed LAUNCH_US; for
# each unit of the busiest block, UNIT_US (its epilogue, and a split's
# partial, fence and arrival) and per chunk 4 x kc / 16 products of 64 x
# 16 weights (two warpgroups, low and high nibbles) of PRODUCT_CYCLES +
# NT_CYCLES x nt cycles each at CLOCK_GHZ; and when the tile splits, the
# merge: MERGE_US and MERGE_US_PER_KB for each KB of f32 partials the last
# block reads.
LAUNCH_US, UNIT_US = 3.5, 2.0
PRODUCT_CYCLES, NT_CYCLES = 45.0, 0.28
CLOCK_GHZ = 1.755
MERGE_US, MERGE_US_PER_KB = 1.0, 0.02
# Among plans within PLAN_SLACK of the least modelled time, the one that
# fills the most SMs (then the least modelled time).
PLAN_SLACK = 0.05
# The wide configuration's model (µs), fitted by `chip_smoke.py
# --sweep-int4` (fit_wide_model: least squares of the relative error, the
# plans' own rows weighted 3) to its rows whose pairs all fit at once (both
# formats, T = 512, 1,024, 2,048, the four 8B shapes: the plans, every
# unit whole, and the other schedules the search weighs; PERF.md §6):
# WIDE_LAUNCH_US (the launch, the ring's first stages, the last store),
# then the busiest pair of blocks: WIDE_CHUNK_US a chunk (four k16 steps of
# 64 x 256 products a warpgroup; INT8's conversion costs more than
# INT4's), WIDE_UNIT_US a unit it ends whole (its epilogue) and
# WIDE_PART_US a segment of a cut unit it writes (128 KB of f32 partials a
# block), times the share of pairs that fit running at once (the partials
# of all of them contend); and when a unit is cut, its merge:
# WIDE_MERGE_US a segment the tile's last block reads, and an epilogue.
# Pairs past those that fit (a forced schedule) run after them.
WIDE_LAUNCH_US = 5.38
WIDE_CHUNK_US = {1: 0.721, 2: 0.691}     # INT8 (one pass), INT4 (two halves)
WIDE_UNIT_US, WIDE_PART_US, WIDE_MERGE_US = 1.93, 8.51, 3.08
# The fewest chunks a pair's stream-K range may hold.
WIDE_MIN_RANGE = 4


def plan_us(p: "MatmulPlan", n_sms: int) -> float:
    """The modelled time (µs) of a launch by plan ``p`` on ``n_sms`` SMs."""
    chunk_us = (4 * p.kc / 16 * (PRODUCT_CYCLES + NT_CYCLES * p.nt)
                / (CLOCK_GHZ * 1e3))
    us = LAUNCH_US + cdiv(p.units, n_sms) * (p.per * chunk_us + UNIT_US)
    if p.splits > 1:
        us += MERGE_US + MERGE_US_PER_KB * p.splits * BM * p.nt * 4 / 1024
    return us


def wide_starts(p: "MatmulPlan") -> list[int]:
    """The stream-K part of wide plan ``p``: the chunks of its units past
    the first ``p.per`` (S = (units - per) x chunks of them, unit v's at
    [v x chunks, (v + 1) x chunks)) in one contiguous range a pair, balanced
    to a chunk. Returns the P + 1 bounds: pair i's range is [starts[i],
    starts[i + 1])."""
    P = p.grid // CLUSTER
    base, rem = divmod((p.units - p.per) * p.chunks, P)
    return [i * base + min(i, rem) for i in range(P + 1)]


def wide_cut_units(p: "MatmulPlan", halves: int) -> dict[int, list[tuple[int, int]]]:
    """The units of wide plan ``p`` that the stream-K part cuts between
    pairs: unit -> its segments (c0, c1), in K order: its pieces, cut again
    where the high nibble half starts (INT4, ``halves`` 2), so that each
    segment lies in one half. The kernel's csrc/wide_matmul.cuh:seg_of."""
    C, cph = p.chunks, p.chunks // halves
    cuts: dict[int, set[int]] = {}
    for g in wide_starts(p)[1:-1]:
        v, c = divmod(g, C)
        if c:
            cuts.setdefault(v, set()).add(c)
    return {p.per + v: [(a, b) for a, b in zip(bounds, bounds[1:])]
            for v, cs in cuts.items()
            for bounds in [sorted(cs | {0, C} | ({cph} if halves == 2 else set()))]}


def wide_work(p: "MatmulPlan") -> list[list[tuple[int, int, int]]]:
    """Each pair's pieces of wide plan ``p`` in the order its blocks walk
    them, (unit, c0, c1): its whole units (pair i: units i, i + P, ...
    below ``p.per``), then its stream-K range cut at the ends of units. The
    kernel's csrc/wide_matmul.cuh:Walk."""
    P, C, starts = p.grid // CLUSTER, p.chunks, wide_starts(p)
    work = []
    for i in range(P):
        mine = [(u, 0, C) for u in range(i, p.per, P)]
        g, g1 = starts[i], starts[i + 1]
        while g < g1:
            v, c0 = divmod(g, C)
            c1 = min(C, c0 + g1 - g)
            mine.append((p.per + v, c0, c1))
            g += c1 - c0
        work.append(mine)
    return work


def wide_plan_us(p: "MatmulPlan", n_sms: int, halves: int) -> float:
    """The modelled time (µs) of a wide launch by plan ``p`` (pairs of
    blocks walking ``wide_work``) of a format of ``halves`` passes: the
    busiest pair's chunks, whole units and partial segments, then the merge
    of the most-cut unit."""
    P, C, starts = p.grid // CLUSTER, p.chunks, wide_starts(p)
    fit = max(1, n_sms // CLUSTER)
    cph, chunk_us = C // halves, WIDE_CHUNK_US[halves]
    part_us = WIDE_PART_US * min(P, fit) / fit
    busiest = 0.0
    for i in range(P):
        us = cdiv(p.per - i, P) * (C * chunk_us + WIDE_UNIT_US) if i < p.per else 0.0
        g, g1 = starts[i], starts[i + 1]
        while g < g1:
            c0 = g % C
            n = min(C - c0, g1 - g)
            us += n * chunk_us + (WIDE_UNIT_US if n == C else
                                  part_us * (2 if c0 < cph < c0 + n else 1))
            g += n
        busiest = max(busiest, us)
    merge = p.splits * WIDE_MERGE_US + WIDE_UNIT_US if p.splits > 1 else 0.0
    return WIDE_LAUNCH_US + cdiv(P, fit) * busiest + merge


def make_wide_plan(T: int, N: int, K: int, halves: int, pairs: int,
                   whole: int) -> "MatmulPlan":
    """The wide configuration's plan on ``pairs`` pairs of blocks with its
    first ``whole`` units walked whole: K/halves weight bytes a row (INT8: 1
    half; INT4: 2, the low and the high nibbles) in chunks of WIDE_KC, a
    unit a pair of weight tiles x a token tile over all of them. Its
    ``per`` is ``whole``, its ``splits`` the most segments a cut unit has
    (1: none is cut), its ``units`` the pairs' units."""
    t_tiles, tiles = cdiv(T, WIDE_NT), cdiv(N, BM)
    cph = cdiv(K // halves, WIDE_KC)
    units = cdiv(tiles, CLUSTER) * t_tiles
    p = MatmulPlan(WIDE_NT, t_tiles, tiles, WIDE_KC, halves * cph, 1, whole,
                   units, CLUSTER * pairs)
    cut = wide_cut_units(p, halves)
    return p._replace(splits=max(map(len, cut.values()), default=1))


def wide_plan(T: int, N: int, K: int, n_sms: int, splits: int | None,
              halves: int) -> "MatmulPlan":
    """The wide configuration's plan on a card of ``n_sms`` SMs (at most one
    block an SM: n_sms // 2 pairs). By default the least modelled time
    (``wide_plan_us``) over the pair counts and, for each, the whole units
    of every full wave, of one wave less, or none (the rest stream-K, at
    least WIDE_MIN_RANGE chunks a pair), or every unit whole; then the most
    pairs. ``splits`` forces the schedule: 1 walks every unit whole on as
    many pairs as fit; more cuts every unit into that many pieces of equal
    length (to a chunk), stream-K on units x splits pairs, more than fit at
    once where need be (the kernel's pairs wait on none other)."""
    fit = max(1, n_sms // CLUSTER)
    units = cdiv(cdiv(N, BM), CLUSTER) * cdiv(T, WIDE_NT)
    chunks = halves * cdiv(K // halves, WIDE_KC)
    if splits is not None:
        if splits <= 1:
            return make_wide_plan(T, N, K, halves, min(fit, units), units)
        pairs = max(1, min(units * splits, units * chunks // WIDE_MIN_RANGE))
        return make_wide_plan(T, N, K, halves, pairs, 0)
    plans = []
    for pairs in range(1, fit + 1):
        waves = units // pairs
        for whole in {units, waves * pairs, max(0, waves - 1) * pairs, 0}:
            rest = (units - whole) * chunks
            if rest and rest < WIDE_MIN_RANGE * pairs:
                continue
            plans.append(make_wide_plan(T, N, K, halves, pairs, whole))
    return min(plans, key=lambda p: (wide_plan_us(p, n_sms, halves), -p.grid, -p.per))


def make_plan(T: int, N: int, n_sms: int, nt: int, splits: int, kc: int,
              chunks: int) -> MatmulPlan:
    """The plan of ``chunks`` K chunks of ``kc`` bytes at token width ``nt``
    in about ``splits`` splits, made such that no split is empty."""
    t_tiles, tiles = cdiv(T, nt), cdiv(N, BM)
    per = cdiv(chunks, max(1, min(splits, chunks)))
    s = cdiv(chunks, per)                # no empty split
    units = tiles * t_tiles * s
    return MatmulPlan(nt, t_tiles, tiles, kc, chunks, s, per, units, min(units, n_sms))


def search_plan(what: str, T: int, N: int, K: int, n_sms: int,
                splits: int | None, nt: int | None, chunking,
                cost, halves: int) -> MatmulPlan:
    """The plan search of the INT4 and INT8 kernels. Up to WIDE_ABOVE
    tokens: over the token widths (the least of TOKEN_WIDTHS that holds T,
    or one down to a quarter of it with more token tiles) and the K splits
    (1 to the chunk count), under ``cost(plan, n_sms)``; above it, the wide
    configuration's schedule (``wide_plan``). Of the narrow plans within
    PLAN_SLACK of the least cost, the one that fills the most SMs (then the
    least cost). ``chunking(width)`` is (bytes a chunk, chunks) at a narrow
    token width; ``halves`` the wide configuration's passes over the
    weights (INT8 1, INT4 2). ``nt`` forces the token width (WIDE_NT: the
    wide configuration at any T), ``splits`` the count (at the widest token
    width unless ``nt`` says otherwise; in the wide configuration,
    ``wide_plan``'s forced schedules). Ints only: no device value reaches
    a plan."""
    for name, v in (("T", T), ("N", N), ("K", K), ("n_sms", n_sms),
                    ("splits", 0 if splits is None else splits),
                    ("nt", 0 if nt is None else nt)):
        if type(v) is not int:
            raise TypeError(f"{what} takes ints, got {name}={v!r}")
    if nt is not None and nt not in TOKEN_WIDTHS + (WIDE_NT,):
        raise ValueError(f"{what}: token width {nt} not in "
                         f"{TOKEN_WIDTHS + (WIDE_NT,)}")
    if is_wide(T, nt):
        return wide_plan(T, N, K, n_sms, splits, halves)
    widest = next(w for w in TOKEN_WIDTHS if w >= min(T, TOKEN_WIDTHS[-1]))
    widths = ([nt] if nt is not None else [widest] if splits is not None
              else [w for w in TOKEN_WIDTHS if widest // 4 <= w <= widest])
    plans = [make_plan(T, N, n_sms, w, s, *chunking(w)) for w in widths
             for s in ([splits] if splits is not None
                       else range(1, chunking(w)[1] + 1))]
    best = min(cost(p, n_sms) for p in plans)
    near = [p for p in plans if cost(p, n_sms) <= (1 + PLAN_SLACK) * best]
    return max(near, key=lambda p: (p.grid, -cost(p, n_sms)))


@functools.lru_cache(maxsize=4096)
def int4_plan(T: int, N: int, K: int, n_sms: int, splits: int | None = None,
              nt: int | None = None) -> MatmulPlan:
    """The kernel's plan for x [T, K] and N output channels on a card of
    ``n_sms`` SMs (one persistent block an SM): the token width and the K
    splits of ``search_plan`` under this kernel's model (``plan_us``). More
    splits or token tiles fill more SMs; each split adds a partial to the
    merge, each token tile the fixed cost of every product again. A forced
    split count is made such that no split is empty. Cached: the search
    costs the host hundreds of µs, a step's launches a dictionary lookup
    each."""
    return search_plan(
        "int4_plan", T, N, K, n_sms, splits, nt,
        lambda w: (chunk_bytes(w), cdiv(K // 2, chunk_bytes(w))), plan_us, 2)


def int4_proj_stacked_plain(x: torch.Tensor, q4: torch.Tensor,
                            s: torch.Tensor, layer: int) -> torch.Tensor:
    """Plain version: unpack layer ``layer``'s nibbles, one f32 product of
    both halves, the scale, one rounding to x's dtype."""
    lo, hi = nibbles(q4[layer])
    half = q4.shape[2]
    acc = (x[:, :half].float() @ lo.float().T
           + x[:, half:].float() @ hi.float().T)
    return (acc * s[layer].float()).to(x.dtype)


def int4_proj_wide_plain(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                         layer: int) -> torch.Tensor:
    """Plain version of the wide configuration: ``quant.proj``'s INT4
    arithmetic on layer ``layer``: a product of each nibble half in x's
    dtype, their sum in x's dtype, the scale, one more rounding."""
    return proj(x, {"q4": q4[layer], "s": s[layer]})


def wide_half_sums(xs: list[torch.Tensor], ws: list[torch.Tensor], p: MatmulPlan,
                   drop: tuple[int, int] | None = None) -> list[torch.Tensor]:
    """The f32 sums [T, N] of each nibble half (INT8: one pass) as wide
    plan ``p`` takes them: ``xs[h]`` holds x's columns of half h and
    ``ws[h]`` its f32 weights [N, K/halves]. A unit's tile is one product,
    but a cut unit's (``wide_cut_units``) is its segments' partial sums,
    added in K order. ``drop`` = (unit, segment) leaves that segment out
    (the fault chip_smoke.py plants against the merge)."""
    halves = len(xs)
    cph = p.chunks // halves
    sums = [xh @ wh.T for xh, wh in zip(xs, ws)]
    for u, segs in wide_cut_units(p, halves).items():
        pt, mt = divmod(u, p.t_tiles)
        rows = slice(CLUSTER * BM * pt, CLUSTER * BM * (pt + 1))
        toks = slice(WIDE_NT * mt, WIDE_NT * (mt + 1))
        for h in range(halves):
            sums[h][toks, rows] = 0
        for j, (c0, c1) in enumerate(segs):
            if (u, j) == drop:
                continue
            h = c0 // cph
            a, b = (c0 - h * cph) * WIDE_KC, (c1 - h * cph) * WIDE_KC
            sums[h][toks, rows] += xs[h][toks, a:b] @ ws[h][rows, a:b].T
    return sums


def int4_wide_split_plain(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                          layer: int, plan: MatmulPlan,
                          drop: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain version of the wide configuration's schedule: each half's f32
    sums as ``plan`` takes them (``wide_half_sums``: a cut unit's segments
    summed in K order), rounded to x's dtype, the two added there, then the
    scale and one more rounding."""
    lo, hi = nibbles(q4[layer])
    half = q4.shape[2]
    xf = x.float()
    a, b = (t.to(x.dtype) for t in wide_half_sums(
        [xf[:, :half], xf[:, half:]], [lo.float(), hi.float()], plan, drop))
    return ((a + b).float() * s[layer].float()).to(x.dtype)


def partials(p: MatmulPlan) -> int:
    """The f32 partials (BM x nt each) a launch by plan ``p`` may write when
    it splits: one a unit; in the wide configuration one a segment of each
    block's tile of every stream-K unit."""
    n = (p.units - p.per) * CLUSTER * p.splits if p.nt == WIDE_NT else p.units
    return n * BM * p.nt


def int4_proj_plain(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                    layer: int, nt: int | None = None) -> torch.Tensor:
    """The plain version of the configuration the kernel takes at x's T
    (``nt`` forced, or None): ``int4_proj_wide_plain`` above WIDE_ABOVE
    tokens, ``int4_proj_stacked_plain`` up to it."""
    wide = is_wide(x.shape[0], nt)
    return (int4_proj_wide_plain if wide else int4_proj_stacked_plain)(x, q4, s, layer)


def int4_split_partials(x: torch.Tensor, q4: torch.Tensor, layer: int,
                        plan: MatmulPlan) -> list[torch.Tensor]:
    """The f32 partial sums [T, N] of the plan's splits, in split order:
    split i covers packed columns [i * per * kc, (i + 1) * per * kc) of
    both halves (the last to K/2)."""
    lo, hi = nibbles(q4[layer])
    half = q4.shape[2]
    xf = x.float()
    parts = []
    for i in range(plan.splits):
        a, b = i * plan.per * plan.kc, min((i + 1) * plan.per * plan.kc, half)
        parts.append(xf[:, a:b] @ lo[:, a:b].float().T
                     + xf[:, half + a:half + b] @ hi[:, a:b].float().T)
    return parts


def int4_proj_split_plain(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                          layer: int, plan: MatmulPlan) -> torch.Tensor:
    """Plain version of split-then-merge: the splits' f32 partials summed in
    split order, then the scale and one rounding to x's dtype."""
    acc = torch.zeros(x.shape[0], q4.shape[1], dtype=torch.float32,
                      device=x.device)
    for p in int4_split_partials(x, q4, layer, plan):
        acc = acc + p
    return (acc * s[layer].float()).to(x.dtype)


def int4_proj_stacked(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                      layer: int, *, splits: int | None = None,
                      nt: int | None = None) -> torch.Tensor:
    """x [T, K] @ dequant(q4[layer])^T * s[layer] → [T, N] in x's dtype.
    q4 int8 [L, N, K/2], s f32 [L, N]. Up to WIDE_ABOVE tokens one rounding
    (the TPU kernel's), above it ``proj``'s (``int4_proj_wide_plain``).
    ``splits`` and ``nt`` force the kernel's split count and token width (a
    measurement's knobs; ``nt=WIDE_NT`` takes the wide configuration at
    any T; the plan chooses by default)."""
    if build.on_cpu("int4_matmul", x, q4, s):
        return int4_proj_plain(x, q4, s, layer, nt)
    wide = is_wide(x.shape[0], nt)
    T, K = x.shape
    L, N, KH = q4.shape
    if x.dtype != torch.bfloat16 or q4.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int4_matmul takes bf16 x, int8 q4, f32 s; got "
                        f"{x.dtype}, {q4.dtype}, {s.dtype}")
    if (K != 2 * KH or s.shape != (L, N) or T <= 0 or not 0 <= layer < L
            or (wide and KH % 16)):
        raise ValueError(f"int4_matmul shapes: x {tuple(x.shape)}, q4 "
                         f"{tuple(q4.shape)}, s {tuple(s.shape)}, layer {layer}"
                         f"{' (K/2 a multiple of 16 above 256 tokens)' if wide else ''}")
    p = int4_plan(T, N, K, build.sm_count(x.device), splits, nt)
    y = torch.empty(T, N, dtype=x.dtype, device=x.device)
    ws = cnt = None
    if p.splits > 1:
        ws = torch.empty(partials(p), dtype=torch.float32, device=x.device)
        # One arrival counter a (tile, token tile); the merging block resets
        # its own, so every launch leaves them zero.
        cnt = build.device_counters("int4_matmul", x.device, p.tiles * p.t_tiles)
    build.launch(
        "int4_matmul", x.device, x.data_ptr(), q4.data_ptr(), s.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), T, N, K, L, int(layer), p.nt,
        p.t_tiles, p.splits, p.per, p.grid)
    return y
