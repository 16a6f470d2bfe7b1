"""The layer's elementwise work for the PyTorch port: CUDA kernels written
by hand for Hopper (sm_90a, ``csrc/layer_ops.cu``) and their plain PyTorch
versions.

Contract (the work that XLA fuses inside the JAX package's layer body,
``swiftllm_tpu/models/llama.py:layer_step`` (510), into its neighbouring
dots or a few fusions a layer):

- ``add_rms_norm(x, r, w, eps) -> (h, x')``: the residual add (616, 623),
  ``x' = x + r`` rounded to x's dtype (``x' = x`` when ``r`` is None, as at
  layer 0's ``attn_norm``), then ``rms_norm`` (244; at 527, 618, 632): the
  variance in f32, ``x' * rsqrt(var + eps)`` cast back to x's dtype BEFORE
  the weight multiply (HF ``LlamaRMSNorm``).
- ``rope_qkv(q, k, v, tables, bias) -> (q_rot, kv)``: the Qwen2 bias adds
  (``biased``, 530-534, at 558-560: each rounded to the activation dtype),
  the half-split RoPE (``apply_rope``, 208, at 578-579) on q and k from the
  step's tables (``rope_tables``, 198: bf16 cos/sin ``[T, 1, hd/2]``), each
  product and sum rounded as ``apply_rope`` rounds it, and the cache row
  ``kv_new = k_rot ‖ v`` (600).
- ``rope_qkv_fp8(q, k, v, tables, bias) -> (q_rot, kv_new)``: the same for
  an fp8 cache, with the quantizing ``kv_new`` build (587-601) folded in:
  the row ``[k_rot * sk, v * sv, sk, sv, 0 ...]`` as e4m3
  (``ops/quantize_kv.py:quantize_kv_plain`` of the bf16 k_rot and v), in
  the one launch.
- Both with ``cache``, ``slots`` and ``layer``: the span write of a mixed
  or prefill step folded in as well, ``cache[layer, slots[t]] = row t`` for
  every slot in ``[0, S)`` (``ops/paged_attention.py:store_kv_plain``; the
  JAX package writes these rows in ``_tiles_kernel``'s fused span write,
  and in verify steps by the scatter ``cache.at[layer,
  kv_slots_scatter].set(kv_new)``, ``swiftllm_tpu/models/llama.py:378``).
  The kernel writes such a row to its page instead of to ``kv_new``: those
  rows of the ``kv_new`` it returns are left unwritten, and nothing may
  read them. The step's slots are -1 at decode-kind and pad tokens, whose
  rows the decode kernel reads from ``kv_new`` (only its valid rows, which
  are packed first).
- ``silu_mul(gate, up)``: ``silu(f32(gate))`` cast back, times ``up``
  (619-621).

The plain versions are the model's arithmetic as it stood before the
kernels (``models/llama.py:forward_shard``), so the CPU computes exactly
what it computed then. The kernels take bf16 only: ``rope_qkv`` is
bit-equal to its plain version, ``rope_qkv_fp8`` byte-equal,
``add_rms_norm``'s ``h`` and ``silu_mul`` within one bf16 rounding of it
(another summation order; the card's ``rsqrtf`` and ``expf``), and
``add_rms_norm``'s ``x'`` bit-equal.

Each wrapper takes its plain version for tensors on the CPU, and only then.
On a CUDA tensor it launches its kernel or raises; it never falls back. It
writes fresh outputs and never its inputs, but for the cache that a rope
wrapper is given, which it writes in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops.paged_attention import (FP8, FP8_SCALE_LANES,
                                                    store_kv_plain)
from swiftllm_tpu_torch.ops.quantize_kv import quantize_kv_plain

KERNELS = ("add_rms_norm", "rope_qkv", "rope_qkv_fp8", "silu_mul")
MAX_NORM_D = 8192      # csrc/layer_ops.cu: kNormVecs x kNormThreads x 8 lanes
# A token's units (rope_units) at most: csrc/layer_ops.cu's kRopeUnits x
# kRopeThreads. Llama-3-8B has 448, a 64-head MHA of head_dim 128 2,048.
MAX_ROPE_UNITS = 2048


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF LlamaRMSNorm: f32 variance, cast back BEFORE the weight multiply."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Half-split (rotate_half) rotary embedding, HF convention.
    x: [T, n_heads, head_dim]; tables: (cos, sin) [T, 1, head_dim/2]."""
    cos, sin = tables
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def add_rms_norm_plain(x: torch.Tensor, r: torch.Tensor | None,
                       weight: torch.Tensor, eps: float):
    """(rms_norm(x'), x') with x' = x + r (x when r is None)."""
    if r is not None:
        x = x + r
    return rms_norm(x, weight, eps), x


def rope_qkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables,
                   bias=None):
    """q [T, n_q*hd], k and v [T, n_kv*hd], tables (cos, sin) [T, 1, hd/2],
    bias (bq, bk, bv) or None -> (q_rot [T, n_q*hd], k_rot ‖ v [T,
    2*n_kv*hd])."""
    if bias is not None:
        bq, bk, bv = bias
        q = q + bq.to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    T, hd = q.shape[0], 2 * tables[0].shape[-1]
    q = apply_rope(q.view(T, -1, hd), tables).reshape(T, -1)
    k = apply_rope(k.view(T, -1, hd), tables).reshape(T, -1)
    return q, torch.cat([k, v], dim=1)


def rope_qkv_fp8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       tables, bias=None):
    """``rope_qkv_plain``, then the fp8 row build of its k_rot and v:
    (q_rot, e4m3 rows [T, 2*n_kv*hd + FP8_SCALE_LANES])."""
    q, kv = rope_qkv_plain(q, k, v, tables, bias)
    KH = k.shape[1]
    return q, quantize_kv_plain(kv[:, :KH], kv[:, KH:])


def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) in f32, cast back, times up."""
    return F.silu(gate.float()).to(gate.dtype) * up


def _bf16(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes bf16 tensors, got {t.dtype}")


def add_rms_norm(x: torch.Tensor, r: torch.Tensor | None, weight: torch.Tensor,
                 eps: float):
    """``add_rms_norm_plain``'s (h, x'), from the kernel for bf16 CUDA
    tensors x and r [T, D] and weight [D] (D a multiple of 8, at most
    MAX_NORM_D), from the plain version for CPU tensors.

    On the card ``weight`` must not be written by the kernel launched just
    before this call on the stream: the launch is programmatic, and the
    kernel reads ``weight`` before it waits for that kernel to complete (x
    and r only after; ``csrc/layer_ops.cu``). A model's norm weight is safe:
    no kernel of a step writes a parameter, only loading the weights does,
    before any step."""
    ins = (x, weight) if r is None else (x, r, weight)
    if build.on_cpu("add_rms_norm", *ins):
        return add_rms_norm_plain(x, r, weight, eps)
    _bf16("add_rms_norm", *ins)
    if (x.dim() != 2 or x.shape[0] < 1 or x.shape[1] % 8
            or x.shape[1] > MAX_NORM_D or weight.shape != x.shape[1:]
            or (r is not None and r.shape != x.shape)):
        raise ValueError(f"add_rms_norm shapes: x {tuple(x.shape)}, r "
                         f"{None if r is None else tuple(r.shape)}, weight "
                         f"{tuple(weight.shape)} (rows of a multiple of 8 lanes, "
                         f"at most {MAX_NORM_D})")
    T, D = x.shape
    h = torch.empty_like(x)
    x_out = x if r is None else torch.empty_like(x)
    build.launch("add_rms_norm", x.device, x.data_ptr(),
                 None if r is None else r.data_ptr(), weight.data_ptr(),
                 None if r is None else x_out.data_ptr(), h.data_ptr(), T, D,
                 float(eps))
    return h, x_out


def rope_units(n_q: int, n_kv: int, hd: int) -> int:
    """A token's units in the rope kernels: a rotated pair of 8-lane
    vectors for each 8 lanes of a q or k head's half, 8 lanes of v."""
    return (n_q + n_kv) * (hd // 16) + n_kv * hd // 8


def _rope_outputs(name: str, q, k, v, tables, bias, dtype, scale_lanes: int,
                  cache, slots, layer: int):
    """Checks ``name``'s inputs (bf16 CUDA tensors, head_dim a multiple of
    16, at most MAX_ROPE_UNITS units a token; with ``slots``, int32 [T] and
    a cache [L, S, row] of the row's dtype and width); returns a fresh
    q_rot, a fresh row [T, 2*KH + scale_lanes] of ``dtype`` and the C
    entry's arguments that write them (and the cache's rows)."""
    cos, sin = tables
    ins = (q, k, v, cos, sin) + tuple(bias or ())
    _bf16(name, *ins)
    half = cos.shape[-1]
    hd = 2 * half
    T, QH = q.shape if q.dim() == 2 else (0, 0)
    KH = k.shape[-1]
    W = 2 * KH + scale_lanes
    if (T < 1 or hd % 16 or QH % hd or KH % hd or k.shape != (T, KH)
            or v.shape != (T, KH) or cos.numel() != T * half
            or sin.shape != cos.shape
            or (bias is not None and [b.shape for b in bias]
                != [(QH,), (KH,), (KH,)])
            or rope_units(QH // hd, KH // hd, hd) > MAX_ROPE_UNITS):
        raise ValueError(
            f"{name} shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, tables {tuple(cos.shape)}, bias "
            f"{None if bias is None else [tuple(b.shape) for b in bias]} "
            f"(head_dim a multiple of 16, at most {MAX_ROPE_UNITS} units a "
            "token)")
    fold = (None, None, 0, 0, 0)
    if slots is not None:
        if slots.dtype != torch.int32 or cache.dtype != dtype:
            raise TypeError(f"{name} writes the cache with int32 slots and a "
                            f"{dtype} cache, got {slots.dtype} and {cache.dtype}")
        if (slots.shape != (T,) or cache.dim() != 3 or cache.shape[2] != W
                or not 0 <= layer < cache.shape[0]):
            raise ValueError(f"{name} cache write: slots {tuple(slots.shape)}, "
                             f"cache {tuple(cache.shape)}, layer {layer} (a "
                             f"[L, S, {W}] cache, a slot a token)")
        fold = (cache.data_ptr(), slots.data_ptr(), cache.shape[1], int(layer),
                W * cache.element_size())
    q_out = torch.empty_like(q)
    kv = torch.empty(T, W, dtype=dtype, device=q.device)
    bq, bk, bv = (None,) * 3 if bias is None else (b.data_ptr() for b in bias)
    return q_out, kv, (q.data_ptr(), k.data_ptr(), v.data_ptr(), bq, bk, bv,
                       cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(),
                       kv.data_ptr(), *fold[:2], T, QH // hd, KH // hd, hd,
                       *fold[2:])


def _rope_on_cpu(name: str, plain, q, k, v, tables, bias, cache, slots,
                 layer: int):
    """``name``'s result from ``plain`` then ``store_kv_plain`` for CPU
    tensors; None for CUDA tensors (the caller launches the kernel)."""
    if (slots is None) != (cache is None):
        raise ValueError(f"{name} writes the cache given both cache and slots")
    fold = () if slots is None else (cache, slots)
    if not build.on_cpu(name, q, k, v, *tables, *(bias or ()), *fold):
        return None
    q_out, kv = plain(q, k, v, tables, bias)
    if slots is not None:
        store_kv_plain(cache, kv, slots, layer)
    return q_out, kv


def rope_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables,
             bias=None, cache=None, slots=None, layer: int = 0):
    """``rope_qkv_plain``'s result, from the kernel for bf16 CUDA tensors
    (head_dim a multiple of 16), from the plain version for CPU tensors.
    With ``cache`` [L, S, 2*n_kv*hd] and ``slots`` i32[T], each row whose
    slot lies in [0, S) is written to ``cache[layer, slot]`` in place (the
    span write), and on the card not to the returned rows (see the module's
    contract); without them, to the returned rows only.

    On the card the biases must not be written by the kernel launched just
    before this call on the stream: the launch is programmatic, and the
    kernel reads them, and the slots, before it waits for that kernel to
    complete (q, k, v and the tables only after, and it writes the cache
    only after; ``csrc/layer_ops.cu``). A model's biases are safe: no kernel
    of a step writes a parameter; and so are a step's slots, written before
    its layers."""
    out = _rope_on_cpu("rope_qkv", rope_qkv_plain, q, k, v, tables, bias,
                       cache, slots, layer)
    if out is not None:
        return out
    q_out, kv, args = _rope_outputs("rope_qkv", q, k, v, tables, bias,
                                    q.dtype, 0, cache, slots, layer)
    build.launch("rope_qkv", q.device, *args)
    return q_out, kv


def rope_qkv_fp8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables,
                 bias=None, cache=None, slots=None, layer: int = 0):
    """``rope_qkv_fp8_plain``'s (q_rot, fp8 row), from the kernel for bf16
    CUDA tensors (head_dim a multiple of 16), from the plain version for
    CPU tensors. The biases, and an fp8 ``cache`` [L, S, 2*n_kv*hd + 128]
    with its ``slots`` and ``layer``, as ``rope_qkv`` takes them."""
    out = _rope_on_cpu("rope_qkv_fp8", rope_qkv_fp8_plain, q, k, v, tables,
                       bias, cache, slots, layer)
    if out is not None:
        return out
    q_out, kv, args = _rope_outputs("rope_qkv_fp8", q, k, v, tables, bias,
                                    FP8, FP8_SCALE_LANES, cache, slots, layer)
    build.launch("rope_qkv_fp8", q.device, *args)
    return q_out, kv


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu_mul_plain(gate, up)``, from the kernel for bf16 CUDA tensors
    [T, F] (F a multiple of 8), from the plain version for CPU tensors."""
    if build.on_cpu("silu_mul", gate, up):
        return silu_mul_plain(gate, up)
    _bf16("silu_mul", gate, up)
    if gate.dim() != 2 or gate.shape[0] < 1 or gate.shape[1] % 8 \
            or up.shape != gate.shape:
        raise ValueError(f"silu_mul shapes: gate {tuple(gate.shape)}, up "
                         f"{tuple(up.shape)} (rows of a multiple of 8 lanes)")
    out = torch.empty_like(gate)
    build.launch("silu_mul", gate.device, gate.data_ptr(), up.data_ptr(),
                 out.data_ptr(), *gate.shape)
    return out
