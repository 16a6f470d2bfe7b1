"""Weight loading for the PyTorch port: HF checkpoints (or seeded dummy
weights) → one rank's shard, a dict of tensors on its device.

A port of ``swiftllm_tpu/worker/weights.py``, with the same tree:
projections kept in the torch ``[out, in]`` layout and stacked over layers
(``[L, out, in]``), norms ``[L, D]``, ``embed`` and ``lm_head`` ``[V, D]``
(the same tensor with tied embeddings), ``final_norm`` ``[D]``, ``inv_freq``
f32 ``[hd/2]``, and Qwen2-style ``bq/bk/bv`` when the config has a qkv bias.

With ``quant`` "int8" or "int4" every projection of ``GEMM_KEYS`` and an
untied ``lm_head`` are stored quantized (``worker/quant.py``): ``{"q" |
"q4": int8[L, N, ...], "s": f32[L, N]}``. They are quantized layer by layer,
after the cast to ``dtype``, on the device. A tied ``lm_head`` stays the
``embed`` tensor, which the embedding gather needs unquantized.

At tp > 1 each rank builds only its shard (``parallel/mesh.py``): every
weight goes to the device one layer at a time, whole, is quantized there
(the scales of an in-sharded row span all its columns) and cut to the
shard, so no rank ever holds the whole model. KV heads are replicated up to
tp where tp > num_kv_heads, and the vocab is padded to a multiple of tp
with zero rows (the head masks them out).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models.llama import compute_inv_freq
from swiftllm_tpu_torch.parallel.mesh import (GEMM_KEYS, SINGLE, Mesh,
                                              effective_num_kv_heads,
                                              param_specs, shard_leaf,
                                              shard_params)
from swiftllm_tpu_torch.utils import cdiv
from swiftllm_tpu_torch.worker.quant import quantize_weight_torch

# The JAX package's dummy-weight scale: uniform(-1e-3, 1e-3).
DUMMY_RANGE = 1e-3


def _stacked(L: int, layer):
    """[L, ...] stacks of ``layer(i)`` (a tensor or a quantized dict), each
    layer written into one preallocated stack as it is made, so the peak
    holds one whole layer beside the stack."""
    first = layer(0)
    if isinstance(first, dict):
        out = {k: v.new_empty((L,) + tuple(v.shape)) for k, v in first.items()}
        for i in range(L):
            d = first if i == 0 else layer(i)
            for k, v in d.items():
                out[k][i] = v
        return out
    out = first.new_empty((L,) + tuple(first.shape))
    for i in range(L):
        out[i] = first if i == 0 else layer(i)
    return out


def _replicate_kv(w: torch.Tensor, nkv: int, nkv_eff: int) -> torch.Tensor:
    """[nkv*hd, ...] → [nkv_eff*hd, ...]: each KV head repeated nkv_eff/nkv
    times, its replicas next to each other."""
    if nkv_eff == nkv:
        return w
    h = w.reshape(nkv, -1, *w.shape[1:])
    return h.repeat_interleave(nkv_eff // nkv, dim=0).reshape(-1, *w.shape[1:])


def _pad_vocab(w: torch.Tensor, tp: int) -> torch.Tensor:
    """Pad the vocab axis to a multiple of tp with zero rows."""
    vp = cdiv(w.shape[0], tp) * tp
    return w if vp == w.shape[0] else torch.cat(
        [w, w.new_zeros((vp - w.shape[0],) + tuple(w.shape[1:]))])


def build_shard(mc: LlamaModelConfig, quant: str, dtype: torch.dtype,
                mesh: Mesh, get, cast_first: bool) -> dict:
    """This rank's shard of the tree, from ``get(key, layer)``: the whole
    tensor of one weight (of one layer for ``layers`` leaves) on the device.
    Each is KV-replicated, padded, cast or quantized (after the cast to
    ``dtype`` with ``cast_first``, else from the tensor as it comes), and
    cut to the shard before the next is fetched."""
    tp, r = mesh.tp, mesh.tp_rank
    nkv_eff = effective_num_kv_heads(mc.num_kv_heads, tp)
    tied = mc.tie_word_embeddings
    specs = param_specs(quant, quantized_lm_head=quant != "none" and not tied,
                        qkv_bias=mc.qkv_bias)

    def leaf(key, i=None):
        t = get(key, i)
        if key in ("wk", "wv", "bk", "bv"):
            t = _replicate_kv(t, mc.num_kv_heads, nkv_eff)
        if key in ("embed", "lm_head"):
            t = _pad_vocab(t, tp)
        spec = specs["layers"][key] if i is not None else specs[key]
        if i is not None:   # a layer's slice: one axis fewer than the stack
            spec = ({k: _drop_layer_axis(v) for k, v in spec.items()}
                    if isinstance(spec, dict) else _drop_layer_axis(spec))
        if quant != "none" and (key in GEMM_KEYS
                                or (key == "lm_head" and not tied)):
            t = quantize_weight_torch(t.to(dtype) if cast_first else t, quant)
            return {k: shard_leaf(v, spec[k], r, tp) for k, v in t.items()}
        return shard_leaf(t, spec, r, tp).to(dtype)   # cut, then cast

    keys = ["attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w_gate", "w_up",
            "w_down"] + (["bq", "bk", "bv"] if mc.qkv_bias else [])
    layers = {k: _stacked(mc.num_layers, lambda i, k=k: leaf(k, i))
              for k in keys}
    embed = leaf("embed")
    return {
        "embed": embed,
        "lm_head": embed if tied else leaf("lm_head"),
        "final_norm": leaf("final_norm"),
        "layers": layers,
    }


def _drop_layer_axis(axis):
    return axis - 1 if isinstance(axis, int) else axis


def weight_shapes(mc: LlamaModelConfig) -> dict:
    """The whole shape of each weight, as ``build_shard``'s ``get`` returns
    it (one layer's for ``layers`` leaves)."""
    D, hd = mc.hidden_size, mc.head_dim
    nq, nkv, F, V = (mc.num_q_heads, mc.num_kv_heads, mc.ffn_inter_dim,
                     mc.vocab_size)
    return {"attn_norm": (D,), "ffn_norm": (D,), "wq": (nq * hd, D),
            "wk": (nkv * hd, D), "wv": (nkv * hd, D), "wo": (D, nq * hd),
            "w_gate": (F, D), "w_up": (F, D), "w_down": (D, F),
            "bq": (nq * hd,), "bk": (nkv * hd,), "bv": (nkv * hd,),
            "embed": (V, D), "lm_head": (V, D), "final_norm": (D,)}


def _dummy_params(mc: LlamaModelConfig, dtype: torch.dtype,
                  device: torch.device, quant: str = "none",
                  seed: int = 0, mesh: Mesh = SINGLE) -> dict:
    """Dummy weights drawn ON the device from a seeded generator,
    uniform(-1e-3, 1e-3) as the JAX package draws them (the generators
    differ, so the values do too). Nothing is uploaded from the host.

    Every weight is drawn whole, in f32, one layer at a time and in one
    order, then cast (or quantized, as the JAX package does under lax.map)
    and cut to this rank's shard: the values are the same at any tp (KV
    heads drawn once and replicated), and no f32 stack of all layers is
    ever built (about 28 GB at 8B)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = weight_shapes(mc)

    def get(key, i):
        return torch.empty(shapes[key], dtype=torch.float32,
                           device=device).uniform_(-DUMMY_RANGE, DUMMY_RANGE,
                                                   generator=gen)
    params = build_shard(mc, quant, dtype, mesh, get, cast_first=False)
    params["inv_freq"] = torch.from_numpy(compute_inv_freq(mc)).to(device)
    return params


def _safetensors_getter(path: str):
    from safetensors import safe_open
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path, encoding="utf-8") as f:
            weight_map = json.load(f)["weight_map"]
    else:
        weight_map = None
    handles: dict[str, object] = {}

    def get(name: str, shape: tuple) -> torch.Tensor:
        fn = weight_map[name] if weight_map else "model.safetensors"
        if fn not in handles:
            handles[fn] = safe_open(os.path.join(path, fn), framework="pt")
        t = handles[fn].get_tensor(name)
        assert tuple(t.shape) == tuple(shape), f"{name}: {tuple(t.shape)} != {shape}"
        return t
    return get


def _torch_bin_getter(path: str):
    index_path = os.path.join(path, "pytorch_model.bin.index.json")
    if os.path.exists(index_path):
        with open(index_path, encoding="utf-8") as f:
            weight_map = json.load(f)["weight_map"]
    else:
        weight_map = {}
    cache: dict[str, dict] = {}

    def get(name: str, shape: tuple) -> torch.Tensor:
        fn = weight_map.get(name, "pytorch_model.bin")
        if fn not in cache:
            cache[fn] = torch.load(os.path.join(path, fn), map_location="cpu",
                                   mmap=True, weights_only=True)
        t = cache[fn][name]
        assert tuple(t.shape) == tuple(shape), f"{name}: {tuple(t.shape)} != {shape}"
        return t
    return get


def _pick_getter(path: str):
    if (os.path.exists(os.path.join(path, "model.safetensors"))
            or os.path.exists(os.path.join(path, "model.safetensors.index.json"))):
        return _safetensors_getter(path)
    if (os.path.exists(os.path.join(path, "pytorch_model.bin"))
            or os.path.exists(os.path.join(path, "pytorch_model.bin.index.json"))):
        return _torch_bin_getter(path)
    raise FileNotFoundError(f"no supported checkpoint found under {path}")


def load_params(engine_config: EngineConfig, model_config: LlamaModelConfig,
                device, mesh: Mesh = SINGLE) -> dict:
    """Build this rank's shard of the parameters on ``device`` (dummy, or
    from the checkpoint at ``engine_config.model_path``), in
    ``engine_config.dtype``."""
    mc = model_config
    device = torch.device(device)
    dtype = getattr(torch, engine_config.dtype)
    quant = engine_config.quant
    if engine_config.use_dummy:
        return _dummy_params(mc, dtype, device, quant, mesh=mesh)
    get = _pick_getter(engine_config.model_path)
    D, hd = mc.hidden_size, mc.head_dim
    nq, nkv, F, V = (mc.num_q_heads, mc.num_kv_heads, mc.ffn_inter_dim,
                     mc.vocab_size)
    names = {
        "attn_norm": ("model.layers.{i}.input_layernorm.weight", (D,)),
        "wq": ("model.layers.{i}.self_attn.q_proj.weight", (nq * hd, D)),
        "wk": ("model.layers.{i}.self_attn.k_proj.weight", (nkv * hd, D)),
        "wv": ("model.layers.{i}.self_attn.v_proj.weight", (nkv * hd, D)),
        "wo": ("model.layers.{i}.self_attn.o_proj.weight", (D, nq * hd)),
        "ffn_norm": ("model.layers.{i}.post_attention_layernorm.weight", (D,)),
        "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", (F, D)),
        "w_up": ("model.layers.{i}.mlp.up_proj.weight", (F, D)),
        "w_down": ("model.layers.{i}.mlp.down_proj.weight", (D, F)),
        "bq": ("model.layers.{i}.self_attn.q_proj.bias", (nq * hd,)),
        "bk": ("model.layers.{i}.self_attn.k_proj.bias", (nkv * hd,)),
        "bv": ("model.layers.{i}.self_attn.v_proj.bias", (nkv * hd,)),
        "embed": ("model.embed_tokens.weight", (V, D)),
        "lm_head": ("lm_head.weight", (V, D)),
        "final_norm": ("model.norm.weight", (D,)),
    }

    def fetch(key, i):
        tmpl, shape = names[key]
        return get(tmpl.format(i=i), shape).to(device=device)
    params = build_shard(mc, quant, dtype, mesh, fetch, cast_first=True)
    params["inv_freq"] = torch.from_numpy(compute_inv_freq(mc)).to(device)
    return params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lora_entry(entry: dict) -> dict:
    """A stacked adapter entry ``{"A": [L, n, r, in], "B": [L, n, out, r]}``
    with B's memory laid out as [L, n, r, out] (its values and shape
    unchanged): a layer's ``B[l].transpose(-1, -2)`` is then a contiguous
    [n, r, out], so ``models/llama.py:lora_add`` reads it as the [n*r, out]
    operand of one GEMM without a copy."""
    return dict(entry, B=entry["B"].transpose(-1, -2).contiguous()
                .transpose(-1, -2))


def specs_of(tree: dict) -> dict:
    """The tp specs (``parallel/mesh.param_specs``) of a parameter tree,
    read from its leaves: the quantization, a quantized ``lm_head``, the
    qkv biases and the LoRA targets."""
    layers = tree["layers"]
    q = next((v for v in layers.values() if isinstance(v, dict)
              and ("q" in v or "q4" in v)), None)
    quant = "none" if q is None else ("int8" if "q" in q else "int4")
    return param_specs(
        quant, quantized_lm_head=isinstance(tree["lm_head"], dict),
        qkv_bias="bq" in layers,
        lora_targets=tuple(k[len("lora_"):] for k in layers
                           if k.startswith("lora_")))


def params_from_numpy(tree: dict, device="cuda", tp_rank: int = 0,
                      tp: int = 1) -> dict:
    """The JAX package's parameter tree (fetched to the host as numpy, its
    vocab padded and its KV heads replicated for ``tp``) → tp rank
    ``tp_rank``'s shard as this port's dict of tensors on ``device``. The
    trees share their keys and layouts, so this is a leaf-by-leaf copy; a
    quantized leaf ``{"q" | "q4", "s"}`` comes across as the same dict, its
    int8 bytes and f32 scales unchanged (an in-sharded INT4 weight repacked
    per shard, ``parallel/mesh.shard_int4_in``), and a LoRA entry
    ``lora_<target>`` and ``lora_scale`` too, B in ``lora_entry``'s memory
    layout."""
    def host(t):
        return ({k: host(v) for k, v in t.items()} if isinstance(t, dict)
                else _to_tensor(t, "cpu"))
    out = shard_params(host(tree), specs_of(tree), tp_rank, tp)

    def to(t):
        return ({k: to(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(device))
    out = to(out)
    for k, v in out["layers"].items():
        if k.startswith("lora_"):
            out["layers"][k] = lora_entry(v)
    return out
