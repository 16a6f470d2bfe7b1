"""Weight-only INT8 matmul (W8A16) for the PyTorch port: a CUDA kernel written
by hand for Hopper (sm_90a, ``csrc/int8_matmul.cu``), its plain PyTorch
versions (unsplit, and split-then-merge), its split plan, and its launch
counter.

Contract (the JAX package's ``swiftllm_tpu/worker/quant.py:proj``, INT8
branch, which XLA fuses so that the weight streams once as int8): ``y[T,
N] = x[T, K] @ q[layer]^T * s[layer]``, q int8 ``[L, N, K]`` and s f32
``[L, N]``, the stacked ``{"q", "s"}`` of ``worker/quant.py``. The rounding
points are ``proj``'s: one f32 sum an output rounded to x's dtype (the
product in x's dtype), back to f32 times the scale, rounded again. So the
plain version computes exactly what ``quant.proj`` computes for an INT8
weight, and x stays bf16 (no activation is quantized).

The kernel reads the stacked weights at the layer's offset: no per-layer
slice is copied, and a single weight (the quantized ``lm_head``) goes in as
a one-layer stack, ``q[None]``, a view. It takes any N, K a multiple of 16
and any T > 0: up to 256 tokens in tiles of 16 to 128 (the decode
buckets), above that in its wide configuration (``csrc/wide_matmul.cuh``:
tiles of 256 tokens, pairs of blocks sharing x; prefill buckets and large
verify heads), with the same rounding points. It cuts K into chunks of KC
bytes (64 in the wide configuration) and may split the chunks of a tile
over several blocks; the last block of a tile to finish sums the splits'
f32 partials in split order (``int8_proj_split_plain`` is the plain version
of that).

The wrapper takes the plain version for tensors on the CPU, and only then. On
a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops.int4_matmul import (BM, CLOCK_GHZ, WIDE_NT,
                                                MatmulPlan, partials,
                                                search_plan, wide_half_sums)
from swiftllm_tpu_torch.utils import cdiv

KC = 128                       # weight bytes a K chunk (csrc/int8_matmul.cu:kKC)

# The narrow plan's model of a launch's time on an H100 (µs), fitted to the
# times of every (token width, splits) pair within 1.5 times the best at the
# four 8B shapes and T = 1, 16, 128, 256 that `chip_smoke.py --sweep-int8`
# prints beside it (its `[fit]` line; NVIDIA H100 80GB HBM3, 700 W): a fixed
# LAUNCH_US; for each unit of the busiest block, UNIT_US (its epilogue, and
# a split's partial, fence and arrival) and per chunk the longer of its
# products (2 x KC / 16 of 64 x 16 weights, PRODUCT_CYCLES + NT_CYCLES x nt
# cycles each at CLOCK_GHZ, queued back to back) and its weight bytes at
# BYTES_PER_US shared by the blocks that stream at once; and when the tile
# splits, the merge: MERGE_US and MERGE_US_PER_KB a KB of f32 partials the
# last block reads.
# The fit puts a launch's fixed cost in UNIT_US (LAUNCH_US came out 0).
LAUNCH_US, UNIT_US = 0.0, 3.397
PRODUCT_CYCLES, NT_CYCLES = 68.17, 0.2753
MERGE_US, MERGE_US_PER_KB = 1.517, 0.01464
BYTES_PER_US = 2.845e6


def plan_us(p: MatmulPlan, n_sms: int) -> float:
    """The modelled time (µs) of a launch by plan ``p`` on ``n_sms`` SMs:
    the launch, each unit of the busiest block (its chunks, the longer of
    their products and their weight bytes, and its fixed cost), and the
    merge of a split tile (the constants above)."""
    products_us = (2 * p.kc / 16 * (PRODUCT_CYCLES + NT_CYCLES * p.nt)
                   / (CLOCK_GHZ * 1e3))
    bytes_us = BM * p.kc * min(p.units, n_sms) / BYTES_PER_US
    us = LAUNCH_US + cdiv(p.units, n_sms) * (p.per * max(products_us, bytes_us)
                                             + UNIT_US)
    if p.splits > 1:
        us += MERGE_US + MERGE_US_PER_KB * p.splits * BM * p.nt * 4 / 1024
    return us


@functools.lru_cache(maxsize=4096)
def int8_plan(T: int, N: int, K: int, n_sms: int, splits: int | None = None,
              nt: int | None = None) -> MatmulPlan:
    """The kernel's plan for x [T, K] and N output channels on a card of
    ``n_sms`` SMs (one persistent block an SM): the token width and the K
    splits of ``int4_matmul.search_plan`` under this kernel's model
    (``plan_us``, K in chunks of KC bytes; above 256 tokens the wide
    configuration's, one pass over the weights). ``nt`` and ``splits``
    force the token width and the split count (made such that no split is
    empty). Ints only, and cached."""
    return search_plan("int8_plan", T, N, K, n_sms, splits, nt,
                       lambda w: (KC, cdiv(K, KC)), plan_us, 1)


def _scaled(acc: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """proj's epilogue: the f32 product rounded to ``dtype``, back to f32
    times the scale, rounded again."""
    return (acc.to(dtype).float() * s.float()).to(dtype)


def int8_proj_stacked_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                            layer: int) -> torch.Tensor:
    """Plain version: one f32 product of layer ``layer``'s int8 weights and
    then ``_scaled``; for an INT8 weight this is ``quant.proj``."""
    return _scaled(F.linear(x.float(), q[layer].float()), s[layer], x.dtype)


def int8_split_partials(x: torch.Tensor, q: torch.Tensor, layer: int,
                        plan: MatmulPlan) -> list[torch.Tensor]:
    """The f32 partial sums [T, N] of a narrow plan's splits, in split
    order: split i covers columns [i * per * kc, (i + 1) * per * kc) (the
    last to K)."""
    xf, w = x.float(), q[layer]
    step = plan.per * plan.kc
    return [F.linear(xf[:, a:a + step], w[:, a:a + step].float())
            for a in range(0, x.shape[1], step)]


def int8_proj_split_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          layer: int, plan: MatmulPlan,
                          drop: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain version of split-then-merge: the splits' f32 partials summed in
    split order, then ``_scaled``; in the wide configuration the f32 sums
    as its schedule takes them (``int4_matmul.wide_half_sums``: a cut
    unit's segments summed in K order, ``drop`` one left out)."""
    if plan.nt == WIDE_NT:
        acc, = wide_half_sums([x.float()], [q[layer].float()], plan, drop)
        return _scaled(acc, s[layer], x.dtype)
    acc = torch.zeros(x.shape[0], q.shape[1], dtype=torch.float32,
                      device=x.device)
    for p in int8_split_partials(x, q, layer, plan):
        acc = acc + p
    return _scaled(acc, s[layer], x.dtype)


def int8_proj_stacked(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      layer: int, *, splits: int | None = None,
                      nt: int | None = None) -> torch.Tensor:
    """x [T, K] @ q[layer]^T * s[layer] → [T, N] in x's dtype, with
    ``proj``'s rounding. q int8 [L, N, K], s f32 [L, N]. ``splits`` and
    ``nt`` force the kernel's split count and token width (a measurement's
    knobs; ``nt=256`` takes the wide configuration at any T; the plan
    chooses by default)."""
    if build.on_cpu("int8_matmul", x, q, s):
        return int8_proj_stacked_plain(x, q, s, layer)
    T, K = x.shape
    L, N, Kq = q.shape
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int8_matmul takes bf16 x, int8 q, f32 s; got "
                        f"{x.dtype}, {q.dtype}, {s.dtype}")
    if K != Kq or K % 16 or s.shape != (L, N) or T <= 0 or not 0 <= layer < L:
        raise ValueError(f"int8_matmul shapes: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, s {tuple(s.shape)}, layer {layer} "
                         "(K a multiple of 16)")
    p = int8_plan(T, N, K, build.sm_count(x.device), splits, nt)
    y = torch.empty(T, N, dtype=x.dtype, device=x.device)
    ws = cnt = None
    if p.splits > 1:
        ws = torch.empty(partials(p), dtype=torch.float32, device=x.device)
        # One arrival counter a (tile, token tile); the merging block resets
        # its own, so every launch leaves them zero.
        cnt = build.device_counters("int8_matmul", x.device, p.tiles * p.t_tiles)
    build.launch(
        "int8_matmul", x.device, x.data_ptr(), q.data_ptr(), s.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), T, N, K, L, int(layer), p.nt,
        p.t_tiles, p.splits, p.per, p.grid)
    return y
