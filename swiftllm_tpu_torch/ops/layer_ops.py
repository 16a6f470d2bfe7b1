"""The layer's elementwise work for the PyTorch port: three CUDA kernels
written by hand for Hopper (sm_90a, ``csrc/layer_ops.cu``) and their plain
PyTorch versions.

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
  ``kv_new = k_rot ‖ v`` (600). With ``split`` (an fp8 cache, whose row
  ``quantize_kv`` builds) ``kv`` is the pair ``(k_rot, v)`` instead.
- ``silu_mul(gate, up)``: ``silu(f32(gate))`` cast back, times ``up``
  (619-621).

The plain versions are the model's arithmetic as it stood before the
kernels (``models/llama.py:forward_shard``), so the CPU computes exactly
what it computed then. The kernels take bf16 only: ``rope_qkv`` is
bit-equal to its plain version, ``add_rms_norm``'s ``h`` and ``silu_mul``
within one bf16 rounding of it (another summation order; the card's
``rsqrtf`` and ``expf``), and ``add_rms_norm``'s ``x'`` bit-equal.

Each wrapper takes its plain version for tensors on the CPU, and only then.
On a CUDA tensor it launches its kernel or raises; it never falls back. It
writes fresh outputs and never its inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from swiftllm_tpu_torch.ops import build

KERNELS = ("add_rms_norm", "rope_qkv", "silu_mul")
MAX_NORM_D = 8192      # csrc/layer_ops.cu: kNormVecs x kNormThreads x 8 lanes


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
                   bias=None, *, split: bool = False):
    """q [T, n_q*hd], k and v [T, n_kv*hd], tables (cos, sin) [T, 1, hd/2],
    bias (bq, bk, bv) or None -> (q_rot [T, n_q*hd], k_rot ‖ v [T,
    2*n_kv*hd]), or (q_rot, (k_rot, v)) with ``split``."""
    if bias is not None:
        bq, bk, bv = bias
        q = q + bq.to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    T, hd = q.shape[0], 2 * tables[0].shape[-1]
    q = apply_rope(q.view(T, -1, hd), tables).reshape(T, -1)
    k = apply_rope(k.view(T, -1, hd), tables).reshape(T, -1)
    return q, ((k, v) if split else torch.cat([k, v], dim=1))


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


def rope_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tables,
             bias=None, *, split: bool = False):
    """``rope_qkv_plain``'s result, from the kernel for bf16 CUDA tensors
    (head_dim a multiple of 16), from the plain version for CPU tensors."""
    cos, sin = tables
    ins = (q, k, v, cos, sin) + tuple(bias or ())
    if build.on_cpu("rope_qkv", *ins):
        return rope_qkv_plain(q, k, v, tables, bias, split=split)
    _bf16("rope_qkv", *ins)
    half = cos.shape[-1]
    hd = 2 * half
    T, QH = q.shape if q.dim() == 2 else (0, 0)
    KH = k.shape[-1]
    if (T < 1 or hd % 16 or QH % hd or KH % hd or k.shape != (T, KH)
            or v.shape != (T, KH) or cos.numel() != T * half
            or sin.shape != cos.shape
            or (bias is not None and [b.shape for b in bias]
                != [(QH,), (KH,), (KH,)])):
        raise ValueError(
            f"rope_qkv shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, tables {tuple(cos.shape)}, bias "
            f"{None if bias is None else [tuple(b.shape) for b in bias]} "
            "(head_dim a multiple of 16)")
    q_out = torch.empty_like(q)
    if split:
        k_out, v_out = torch.empty_like(k), torch.empty_like(v)
        kv, kv_ptrs, ld = (k_out, v_out), (k_out.data_ptr(), v_out.data_ptr()), KH
    else:
        kv = torch.empty(T, 2 * KH, dtype=q.dtype, device=q.device)
        kv_ptrs = (kv.data_ptr(), kv.data_ptr() + KH * kv.element_size())
        ld = 2 * KH
    bq, bk, bv = (None,) * 3 if bias is None else (b.data_ptr() for b in bias)
    build.launch("rope_qkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bq, bk, bv, cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(),
                 *kv_ptrs, T, QH // hd, KH // hd, hd, ld)
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
