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
version of that). The TPU kernel's tile picking and sublane padding have no
Hopper counterpart.

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
    persistent blocks."""
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
# The wide configuration's model (µs), fitted to its rows of
# `chip_smoke.py --sweep-int4` (both formats, T = 512, 1,024, 2,048, the
# four 8B shapes, 1 to 8 splits; PERF.md §6, PR 14): a fixed LAUNCH_US;
# for each unit of the busiest pair of blocks, WIDE_UNIT_US (its epilogue)
# and WIDE_CHUNK_US a chunk (4 k16 steps of 64 x 256 products a
# warpgroup, both formats), and when the tile splits, WIDE_SPLIT_US and
# WIDE_SPLIT_US_PER a split times the share of pairs busy (each unit
# writes a 128 KB partial, each tile's last reads them all: the card's
# bandwidth, shared by the pairs that do it at once).
WIDE_CHUNK_US, WIDE_UNIT_US = 0.76, 3.7
WIDE_SPLIT_US, WIDE_SPLIT_US_PER = 4.0, 3.0


def plan_us(p: "MatmulPlan", n_sms: int) -> float:
    """The modelled time (µs) of a launch by plan ``p`` on ``n_sms`` SMs."""
    chunk_us = (4 * p.kc / 16 * (PRODUCT_CYCLES + NT_CYCLES * p.nt)
                / (CLOCK_GHZ * 1e3))
    us = LAUNCH_US + cdiv(p.units, n_sms) * (p.per * chunk_us + UNIT_US)
    if p.splits > 1:
        us += MERGE_US + MERGE_US_PER_KB * p.splits * BM * p.nt * 4 / 1024
    return us


def wide_plan_us(p: "MatmulPlan", n_sms: int) -> float:
    """The modelled time (µs) of a wide launch by plan ``p`` on ``n_sms``
    SMs (pairs of blocks: the units of a pair of weight tiles)."""
    pairs = cdiv(p.tiles, CLUSTER) * p.t_tiles * p.splits
    fit = max(1, n_sms // CLUSTER)
    unit_us = p.per * WIDE_CHUNK_US + WIDE_UNIT_US
    if p.splits > 1:
        unit_us += WIDE_SPLIT_US + WIDE_SPLIT_US_PER * p.splits * min(pairs, fit) / fit
    return LAUNCH_US + cdiv(pairs, fit) * unit_us


def make_wide_plan(T: int, N: int, K: int, n_sms: int, splits: int,
                   halves: int) -> MatmulPlan:
    """The wide configuration's plan in about ``splits`` splits, none empty:
    K/halves weight bytes a row (INT8: 1 half; INT4: 2, the low and the high
    nibbles) in chunks of WIDE_KC. An unsplit unit walks every chunk of
    both halves (``per`` = all of them); a split takes ``per`` chunks of
    one half, and each half has the same splits (INT4's count is even)."""
    t_tiles, tiles = cdiv(T, WIDE_NT), cdiv(N, BM)
    cph = cdiv(K // halves, WIDE_KC)
    if splits < max(2, halves):          # unsplit (INT4: counts round down to even)
        s, per = 1, halves * cph
    else:
        per = cdiv(cph, min(splits // halves, cph))
        s = halves * cdiv(cph, per)
    pairs = cdiv(tiles, CLUSTER) * t_tiles * s
    return MatmulPlan(WIDE_NT, t_tiles, tiles, WIDE_KC, halves * cph, s, per,
                      tiles * t_tiles * s,
                      CLUSTER * min(pairs, max(1, n_sms // CLUSTER)))


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
    configuration's splits under ``wide_plan_us``. Of the plans within
    PLAN_SLACK of the least cost, the one that fills the most SMs (then the
    least cost). ``chunking(width)`` is (bytes a chunk, chunks) at a narrow
    token width; ``halves`` the wide configuration's passes over the
    weights (INT8 1, INT4 2). ``nt`` forces the token width (WIDE_NT: the
    wide configuration at any T), ``splits`` the count (at the widest token
    width unless ``nt`` says otherwise). Ints only: no device value reaches
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
        plans = [make_wide_plan(T, N, K, n_sms, s, halves)
                 for s in ([splits] if splits is not None
                           else range(1, halves * cdiv(K // halves, WIDE_KC) + 1))]
        cost = wide_plan_us
    else:
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


def int4_wide_split_plain(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                          layer: int, plan: MatmulPlan) -> torch.Tensor:
    """Plain version of the wide configuration's split-then-merge: each
    half's f32 partials (split i of a half covers packed columns [i * per *
    kc, (i + 1) * per * kc) of it; an unsplit plan, all of it) summed in
    split order and rounded to x's dtype, the two added there, then the
    scale and one more rounding."""
    lo, hi = nibbles(q4[layer])
    half = q4.shape[2]
    step = half if plan.splits == 1 else plan.per * plan.kc
    xf = x.float()
    sums = []
    for h, w in ((0, lo), (1, hi)):
        acc = torch.zeros(x.shape[0], q4.shape[1], dtype=torch.float32,
                          device=x.device)
        for a in range(0, half, step):
            b = min(a + step, half)
            acc = acc + xf[:, h * half + a:h * half + b] @ w[:, a:b].float().T
        sums.append(acc.to(x.dtype))
    return ((sums[0] + sums[1]).float() * s[layer].float()).to(x.dtype)


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
        ws = torch.empty(p.units * BM * p.nt, dtype=torch.float32, device=x.device)
        # One arrival counter a (tile, token tile); the merging block resets
        # its own, so every launch leaves them zero.
        cnt = build.device_counters("int4_matmul", x.device, p.tiles * p.t_tiles)
    build.launch(
        "int4_matmul", x.device, x.data_ptr(), q4.data_ptr(), s.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), T, N, K, L, int(layer), p.nt,
        p.t_tiles, p.splits, p.per, p.grid)
    return y
