"""Fused INT4 dequant-matmul for the PyTorch port: a CUDA kernel written by
hand for Hopper (sm_90a, ``csrc/int4_matmul.cu``), its plain PyTorch
version, and its launch counter.

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
larger buckets through ``proj``). The TPU kernel's tile picking and sublane
padding have no Hopper counterpart.

The wrapper takes the plain version for tensors on the CPU, and only then. On
a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import torch

from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.worker.quant import nibbles

MAX_T = 256
NUM_SMS = 132              # H100 SXM
_BN = 128                  # output columns per block (csrc/int4_matmul.cu)
_BKH = 32                  # packed bytes per K chunk


def int4_proj_stacked_plain(x: torch.Tensor, q4: torch.Tensor,
                            s: torch.Tensor, layer: int) -> torch.Tensor:
    """Plain version: unpack layer ``layer``'s nibbles, one f32 product of
    both halves, the scale, one rounding to x's dtype."""
    lo, hi = nibbles(q4[layer])
    half = q4.shape[2]
    acc = (x[:, :half].float() @ lo.float().T
           + x[:, half:].float() @ hi.float().T)
    return (acc * s[layer].float()).to(x.dtype)


def split_k(T: int, N: int, K: int) -> int:
    """K splits of one launch: the nearest to about two blocks per SM (four
    for small token counts, whose blocks are light), so that the blocks come
    close to one full wave; each split at least one K chunk. The splits' f32
    partial sums are added by a second pass."""
    m_tiles = -(-T // 128)
    blocks = m_tiles * -(-N // _BN)
    target = NUM_SMS * (2 if T > 32 else 4)
    chunks = -(-(K // 2) // _BKH)
    splits = min(chunks, max(1, int(target / blocks + 0.5)))
    per = -(-chunks // splits)
    return -(-chunks // per)


def int4_proj_stacked(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                      layer: int) -> torch.Tensor:
    """x [T, K] @ dequant(q4[layer])^T * s[layer] → [T, N] in x's dtype.
    q4 int8 [L, N, K/2], s f32 [L, N]."""
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
    y = torch.empty(T, N, dtype=x.dtype, device=x.device)
    splits = split_k(T, N, K)
    ws = (torch.empty(splits, T, N, dtype=torch.float32, device=x.device)
          if splits > 1 else y)
    err = build.entry("int4_matmul")(
        x.data_ptr(), q4.data_ptr(), s.data_ptr(), y.data_ptr(), ws.data_ptr(),
        T, N, K, int(layer), splits, build.stream())
    build.check_launch("int4_matmul", err)
    return y
