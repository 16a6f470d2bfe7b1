"""Weight-only quantization for the PyTorch port: INT8 and packed INT4 with
per-output-channel scales.

The port's own copy of ``swiftllm_tpu/worker/quant.py`` (which imports JAX),
with the same layouts and the same rounding points:

- Weights live in the ``[out, in]`` GEMM layout and quantize to ``{"q":
  int8[..., out, in], "s": f32[..., out]}`` (int8) or ``{"q4": int8[...,
  out, in/2], "s": f32[..., out]}`` (int4, values in [-7, 7]).
- INT4 packing is SPLIT-HALF: byte j holds column j in its low nibble and
  column in/2 + j in its high nibble. It is not the interleaved layout
  (columns 2j and 2j + 1) that most W4A16 code assumes.
- ``x @ dequant(w)^T == (x @ q^T) * s``: the scale is constant along the
  contraction, so ``proj`` multiplies the product, not the weight.

``proj`` is the plain path: bf16 weights, CPU tensors, and quantized weights
when the model runs without kernels. With kernels every quantized projection
and a quantized ``lm_head``, in every bucket, go through the weight kernels
(``ops/int8_matmul.py``, ``ops/int4_matmul.py``), which stream the weights as
stored, as XLA fuses the int8 → bf16 convert into the dot. ``proj`` is
``F.linear`` on the dequantized weight, so it writes and reads a bf16 copy
of the weight; above 256 tokens the INT4 kernel computes its arithmetic
(``int4_matmul.int4_proj_wide_plain``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# proj dequantizes at most this many weight elements at a time (rows of the
# output axis): it bounds the bf16 transient of a quantized lm_head
# (128,256 x 4,096) to 128 MB without changing a single output value.
PROJ_CHUNK_ELEMS = 1 << 26


def quantize_int8(w: np.ndarray) -> dict:
    """w: [..., out, in] float → {"q": int8[..., out, in], "s": f32[..., out]}."""
    w32 = np.asarray(w, np.float32)
    s = np.max(np.abs(w32), axis=-1) / 127.0           # [..., out]
    s = np.maximum(s, 1e-12)
    q = np.clip(np.rint(w32 / s[..., None]), -127, 127).astype(np.int8)
    return {"q": q, "s": s.astype(np.float32)}


def quantize_int4(w: np.ndarray) -> dict:
    """w: [..., out, in] float → {"q4": int8[..., out, in//2] (two nibbles/byte),
    "s": f32[..., out]}. in must be even. Values in [-7, 7], split-half
    packed."""
    w32 = np.asarray(w, np.float32)
    assert w32.shape[-1] % 2 == 0, "int4 packing needs an even contraction dim"
    s = np.max(np.abs(w32), axis=-1) / 7.0
    s = np.maximum(s, 1e-12)
    q = np.clip(np.rint(w32 / s[..., None]), -7, 7).astype(np.int8)
    half = q.shape[-1] // 2
    lo = q[..., :half] & 0xF
    hi = q[..., half:] & 0xF
    packed = (lo | (hi << 4)).astype(np.int8)
    return {"q4": packed, "s": s.astype(np.float32)}


def quantize_weight_torch(w: torch.Tensor, quant: str):
    """``quantize_int8`` / ``quantize_int4`` (or w itself for "none") for a
    tensor that is already on its device: the same bytes as the numpy
    quantizers (int8 shifts wrap as numpy's do). Quantizes in f32 whatever
    w's dtype."""
    if quant == "none":
        return w
    w32 = w.float()
    qmax = {"int8": 127.0, "int4": 7.0}.get(quant)
    if qmax is None:
        raise ValueError(f"unknown quant mode {quant!r}")
    # Divide by a tensor on w's device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is an ulp off numpy's
    # quotient for some rows.
    s = torch.clamp_min(w32.abs().amax(dim=-1) / w32.new_tensor(qmax), 1e-12)
    q = torch.clamp(torch.round(w32 / s[..., None]), -qmax, qmax).to(torch.int8)
    if quant == "int8":
        return {"q": q, "s": s}
    if q.shape[-1] % 2:
        raise ValueError("int4 packing needs an even contraction dim")
    half = q.shape[-1] // 2
    return {"q4": (q[..., :half] & 0xF) | (q[..., half:] << 4), "s": s}


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8[..., out, in//2] split-half nibbles → int8[..., out, in],
    sign-extended (see quantize_int4 for the layout)."""
    return torch.cat(nibbles(packed), dim=-1)


def nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) nibbles of int8 bytes, each sign-extended to int8."""
    return (packed << 4) >> 4, packed >> 4


def is_quantized(w) -> bool:
    return isinstance(w, dict)


def out_features(w) -> int:
    if is_quantized(w):
        key = "q" if "q" in w else "q4"
        return w[key].shape[-2]
    return w.shape[-2]


def _proj_rows(x: torch.Tensor, w: dict) -> torch.Tensor:
    """proj's quantized product for one block of output rows."""
    if "q" in w:
        y = F.linear(x, w["q"].to(x.dtype))
    else:
        # Split-half int4: two half-contraction products, one per nibble,
        # each rounded to x's dtype and added there, as the JAX package does.
        lo, hi = nibbles(w["q4"])
        half = x.shape[1] // 2
        y = (F.linear(x[:, :half], lo.to(x.dtype))
             + F.linear(x[:, half:], hi.to(x.dtype)))
    return (y.float() * w["s"]).to(x.dtype)


def proj(x: torch.Tensor, w) -> torch.Tensor:
    """x[T, in] @ weight[out, in]^T → [T, out]; weight is a plain tensor or a
    quantize_* dict. Output dtype = x.dtype. A quantized weight is
    dequantized PROJ_CHUNK_ELEMS elements at a time along its output rows;
    every output column is the same as in one product."""
    if not is_quantized(w):
        return F.linear(x, w)
    n = out_features(w)
    rows = max(1, PROJ_CHUNK_ELEMS // x.shape[1])
    if n <= rows:
        return _proj_rows(x, w)
    return torch.cat([_proj_rows(x, {k: v[i:i + rows] for k, v in w.items()})
                      for i in range(0, n, rows)], dim=1)
