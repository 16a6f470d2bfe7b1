"""The fp8 KV cache's row build for the PyTorch port, in plain PyTorch, with
the per-token power-of-two scales (``fp8_scales``).

Contract (the JAX package's quantizing ``kv_new`` build,
``swiftllm_tpu/models/llama.py:587-601``, which XLA fuses into its
neighbours): one step's K and V rows ``[T, KH]`` become fp8 cache rows
``[T, 2*KH + FP8_SCALE_LANES]``: each token's K and V times its own scale
(from the row's absmax), clipped to +-448 (e4m3fn has no inf: an
overflowing cast would give NaN), then the scale lanes (K scale, V scale,
zeros), all cast to e4m3 at once.

On the card the build has no kernel of its own: ``ops/layer_ops.py:
rope_qkv_fp8`` writes the same bytes in the launch that rotates k, so that
a layer's row costs one launch. ``quantize_kv_plain`` is that kernel's plain
version's second half, and the CPU's row build.
"""

from __future__ import annotations

import torch

from swiftllm_tpu_torch.ops.paged_attention import FP8, FP8_SCALE_LANES


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


def quantize_kv_plain(kf: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
    """One step's K and V rows ([T, n_kv*hd] each, any float dtype) as fp8
    cache rows [T, 2*n_kv*hd + FP8_SCALE_LANES], in plain PyTorch."""
    kv = torch.stack([kf, vf], dim=1).float()                         # [T, 2, KH]
    scales = fp8_scales(kv.abs().amax(dim=2))                         # [T, 2]
    lanes = kv.new_zeros(kv.shape[0], FP8_SCALE_LANES)
    lanes[:, :2] = scales
    stored = (kv * scales[:, :, None]).clamp(-448.0, 448.0)
    return torch.cat([stored.flatten(1), lanes], dim=1).to(FP8)
