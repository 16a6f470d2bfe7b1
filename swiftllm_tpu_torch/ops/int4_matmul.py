"""Fused INT4 dequant-matmul for the PyTorch port: a CUDA kernel written by
hand for Hopper (sm_90a, ``csrc/int4_matmul.cu``), its plain PyTorch
versions (unsplit, and split-then-merge), its split plan, and its launch
counter.

Contract (the same as ``swiftllm_tpu/ops/int4_matmul.py:int4_proj_stacked``):
``y[T, N] = x[T, K] @ dequant(q4[layer])^T * s[layer]``, with q4 ``[L, N,
K/2]`` int8 split-half packed (byte j = column j in the low nibble, column
K/2 + j in the high nibble; see ``worker/quant.py``) and s ``[L, N]`` f32
per-output-channel scales. The product accumulates in f32, is multiplied by
the scale, and is rounded to x's dtype ONCE (the TPU kernel's numerics, not
``proj``'s two rounded half-products).

The kernel reads the stacked weights at the layer's offset, as the TPU
kernel takes the layer by scalar prefetch: no per-layer slice is copied. It
takes any N, any even K and T <= 256 (the decode buckets; the model sends
larger buckets through ``proj``). It cuts K into chunks of packed bytes
(``chunk_bytes``) and may split the chunks of a tile over several blocks;
the last block of a tile to finish sums the splits' f32 partials in split
order (``int4_proj_split_plain`` is the plain version of that). The TPU
kernel's tile picking and sublane padding have no Hopper counterpart.

The wrapper takes the plain version for tensors on the CPU, and only then. On
a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.utils import cdiv
from swiftllm_tpu_torch.worker.quant import nibbles

MAX_T = 256
BM = 128                      # weight rows a tile (csrc/int4_matmul.cu:kBM)
TOKEN_WIDTHS = (16, 32, 64, 128)   # the kernel's token-tile widths (NT)


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


def plan_us(p: "MatmulPlan", n_sms: int) -> float:
    """The modelled time (µs) of a launch by plan ``p`` on ``n_sms`` SMs."""
    chunk_us = (4 * p.kc / 16 * (PRODUCT_CYCLES + NT_CYCLES * p.nt)
                / (CLOCK_GHZ * 1e3))
    us = LAUNCH_US + cdiv(p.units, n_sms) * (p.per * chunk_us + UNIT_US)
    if p.splits > 1:
        us += MERGE_US + MERGE_US_PER_KB * p.splits * BM * p.nt * 4 / 1024
    return us


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
                cost) -> MatmulPlan:
    """The plan search of the INT4 and INT8 kernels: over the token widths
    (the least of TOKEN_WIDTHS that holds T, or one down to a quarter of it
    with more token tiles) and the K splits (1 to the chunk count), of the
    plans whose ``cost(plan, n_sms)`` is within PLAN_SLACK of the least,
    the one that fills the most SMs (then the least cost).
    ``chunking(width)`` is (bytes a chunk, chunks) at a token width. ``nt``
    forces the token width, ``splits`` the count (at the widest token width
    unless ``nt`` says otherwise). Ints only: no device value reaches a
    plan."""
    for name, v in (("T", T), ("N", N), ("K", K), ("n_sms", n_sms),
                    ("splits", 0 if splits is None else splits),
                    ("nt", 0 if nt is None else nt)):
        if type(v) is not int:
            raise TypeError(f"{what} takes ints, got {name}={v!r}")
    widest = next(w for w in TOKEN_WIDTHS if w >= min(T, TOKEN_WIDTHS[-1]))
    if nt is not None and nt not in TOKEN_WIDTHS:
        raise ValueError(f"{what}: token width {nt} not in {TOKEN_WIDTHS}")
    widths = ([nt] if nt is not None else [widest] if splits is not None
              else [w for w in TOKEN_WIDTHS if widest // 4 <= w <= widest])
    plans = [make_plan(T, N, n_sms, w, s, *chunking(w)) for w in widths
             for s in ([splits] if splits is not None
                       else range(1, chunking(w)[1] + 1))]
    best = min(cost(p, n_sms) for p in plans)
    near = [p for p in plans if cost(p, n_sms) <= (1 + PLAN_SLACK) * best]
    return max(near, key=lambda p: (min(p.units, n_sms), -cost(p, n_sms)))


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
        lambda w: (chunk_bytes(w), cdiv(K // 2, chunk_bytes(w))), plan_us)


def int4_proj_stacked_plain(x: torch.Tensor, q4: torch.Tensor,
                            s: torch.Tensor, layer: int) -> torch.Tensor:
    """Plain version: unpack layer ``layer``'s nibbles, one f32 product of
    both halves, the scale, one rounding to x's dtype."""
    lo, hi = nibbles(q4[layer])
    half = q4.shape[2]
    acc = (x[:, :half].float() @ lo.float().T
           + x[:, half:].float() @ hi.float().T)
    return (acc * s[layer].float()).to(x.dtype)


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
    q4 int8 [L, N, K/2], s f32 [L, N]. ``splits`` and ``nt`` force the
    kernel's split count and token width (a measurement's knobs; the plan
    chooses by default)."""
    if build.on_cpu("int4_matmul", x, q4, s):
        return int4_proj_stacked_plain(x, q4, s, layer)
    T, K = x.shape
    L, N, KH = q4.shape
    if x.dtype != torch.bfloat16 or q4.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int4_matmul takes bf16 x, int8 q4, f32 s; got "
                        f"{x.dtype}, {q4.dtype}, {s.dtype}")
    if K != 2 * KH or s.shape != (L, N) or not 0 < T <= MAX_T or not 0 <= layer < L:
        raise ValueError(f"int4_matmul shapes: x {tuple(x.shape)}, q4 "
                         f"{tuple(q4.shape)}, s {tuple(s.shape)}, layer {layer}")
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
