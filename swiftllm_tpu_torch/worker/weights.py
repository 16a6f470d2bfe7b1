"""Weight loading for the PyTorch port: HF checkpoints (or seeded dummy
weights) → a dict of tensors on one device.

A port of ``swiftllm_tpu/worker/weights.py`` at tp = 1, with the same tree:
projections kept in the torch ``[out, in]`` layout and stacked over layers
(``[L, out, in]``), norms ``[L, D]``, ``embed`` and ``lm_head`` ``[V, D]``
(the same tensor with tied embeddings), ``final_norm`` ``[D]``, ``inv_freq``
f32 ``[hd/2]``, and Qwen2-style ``bq/bk/bv`` when the config has a qkv bias.

With ``quant`` "int8" or "int4" every projection of ``GEMM_KEYS`` and an
untied ``lm_head`` are stored quantized (``worker/quant.py``): ``{"q" |
"q4": int8[L, N, ...], "s": f32[L, N]}``. They are quantized layer by layer,
after the cast to ``dtype``, on the device. A tied ``lm_head`` stays the
``embed`` tensor, which the embedding gather needs unquantized.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models.llama import compute_inv_freq
from swiftllm_tpu_torch.worker.quant import quantize_weight_torch

# The JAX package's dummy-weight scale: uniform(-1e-3, 1e-3).
DUMMY_RANGE = 1e-3

# The projections, which quant stores quantized (the JAX package's
# parallel/mesh.py:GEMM_KEYS).
GEMM_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def stack_quantized(per_layer: list) -> dict:
    """Per-layer quantize_* dicts → one dict of [L, ...] stacks."""
    return {k: torch.stack([d[k] for d in per_layer]) for k in per_layer[0]}


def _dummy_params(mc: LlamaModelConfig, dtype: torch.dtype,
                  device: torch.device, quant: str = "none",
                  seed: int = 0) -> dict:
    """Dummy weights drawn ON the device from a seeded generator,
    uniform(-1e-3, 1e-3) as the JAX package draws them (the generators
    differ, so the values do too). Nothing is uploaded from the host. A
    quantized projection is drawn one layer at a time in f32 and quantized
    there, as the JAX package does under lax.map: no f32 stack of all
    layers is ever built (about 28 GB at 8B)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    D, hd = mc.hidden_size, mc.head_dim
    nq, nkv, F, V, L = (mc.num_q_heads, mc.num_kv_heads, mc.ffn_inter_dim,
                        mc.vocab_size, mc.num_layers)

    def w(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device).uniform_(
            -DUMMY_RANGE, DUMMY_RANGE, generator=gen)

    def gemm(*shape):
        if quant == "none":
            return w(*shape)
        if len(shape) == 2:
            return quantize_weight_torch(w(*shape, dt=torch.float32), quant)
        return stack_quantized([quantize_weight_torch(
            w(*shape[1:], dt=torch.float32), quant) for _ in range(shape[0])])

    layers = {
        "attn_norm": w(L, D),
        "wq": gemm(L, nq * hd, D),
        "wk": gemm(L, nkv * hd, D),
        "wv": gemm(L, nkv * hd, D),
        "wo": gemm(L, D, nq * hd),
        "ffn_norm": w(L, D),
        "w_gate": gemm(L, F, D),
        "w_up": gemm(L, F, D),
        "w_down": gemm(L, D, F),
    }
    if mc.qkv_bias:
        layers.update(bq=w(L, nq * hd), bk=w(L, nkv * hd), bv=w(L, nkv * hd))
    embed = w(V, D)
    return {
        "embed": embed,
        "lm_head": embed if mc.tie_word_embeddings else gemm(V, D),
        "final_norm": w(D),
        "inv_freq": torch.from_numpy(compute_inv_freq(mc)).to(device),
        "layers": layers,
    }


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


def effective_num_kv_heads(model_config: LlamaModelConfig, tp: int) -> int:
    """KV heads actually materialized: replicated up to tp when tp > num_kv_heads."""
    nkv = model_config.num_kv_heads
    if tp <= nkv:
        assert nkv % tp == 0, f"num_kv_heads={nkv} not divisible by tp={tp}"
        return nkv
    assert tp % nkv == 0, f"tp={tp} not a multiple of num_kv_heads={nkv}"
    return tp


def load_params(engine_config: EngineConfig, model_config: LlamaModelConfig,
                device) -> dict:
    """Build the parameter dict on ``device`` (dummy or from the checkpoint
    at ``engine_config.model_path``), in ``engine_config.dtype``."""
    mc = model_config
    device = torch.device(device)
    dtype = getattr(torch, engine_config.dtype)
    quant = engine_config.quant
    if engine_config.use_dummy:
        return _dummy_params(mc, dtype, device, quant)
    get = _pick_getter(engine_config.model_path)
    D, hd = mc.hidden_size, mc.head_dim
    nq, nkv, F, V, L = (mc.num_q_heads, mc.num_kv_heads, mc.ffn_inter_dim,
                        mc.vocab_size, mc.num_layers)
    layer_names = {
        "attn_norm": ("model.layers.{i}.input_layernorm.weight", (D,)),
        "wq": ("model.layers.{i}.self_attn.q_proj.weight", (nq * hd, D)),
        "wk": ("model.layers.{i}.self_attn.k_proj.weight", (nkv * hd, D)),
        "wv": ("model.layers.{i}.self_attn.v_proj.weight", (nkv * hd, D)),
        "wo": ("model.layers.{i}.self_attn.o_proj.weight", (D, nq * hd)),
        "ffn_norm": ("model.layers.{i}.post_attention_layernorm.weight", (D,)),
        "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", (F, D)),
        "w_up": ("model.layers.{i}.mlp.up_proj.weight", (F, D)),
        "w_down": ("model.layers.{i}.mlp.down_proj.weight", (D, F)),
    }
    if mc.qkv_bias:
        layer_names.update(
            bq=("model.layers.{i}.self_attn.q_proj.bias", (nq * hd,)),
            bk=("model.layers.{i}.self_attn.k_proj.bias", (nkv * hd,)),
            bv=("model.layers.{i}.self_attn.v_proj.bias", (nkv * hd,)))

    def fetch(name, shape, is_gemm=False):
        t = get(name, shape).to(device=device, dtype=dtype)
        return quantize_weight_torch(t, quant) if is_gemm else t

    layers = {}
    for key, (tmpl, shape) in layer_names.items():
        per_layer = [fetch(tmpl.format(i=i), shape, key in GEMM_KEYS)
                     for i in range(L)]
        layers[key] = (stack_quantized(per_layer) if isinstance(per_layer[0], dict)
                       else torch.stack(per_layer))
    embed = fetch("model.embed_tokens.weight", (V, D))
    return {
        "embed": embed,
        "lm_head": (embed if mc.tie_word_embeddings
                    else fetch("lm_head.weight", (V, D), is_gemm=True)),
        "final_norm": fetch("model.norm.weight", (D,)),
        "inv_freq": torch.from_numpy(compute_inv_freq(mc)).to(device),
        "layers": layers,
    }


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


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The JAX package's parameter tree (tp = 1, fetched to the host as
    numpy) → this port's dict of tensors on ``device``. The trees share their
    keys and layouts, so this is a leaf-by-leaf copy; a quantized leaf
    ``{"q" | "q4", "s"}`` comes across as the same dict, its int8 bytes and
    f32 scales unchanged, and a LoRA entry ``lora_<target>`` and
    ``lora_scale`` too, B in ``lora_entry``'s memory layout."""
    out = {k: (params_from_numpy(v, device) if isinstance(v, dict)
               else _to_tensor(v, device))
           for k, v in tree.items()}
    for k, v in out.items():
        if k.startswith("lora_") and isinstance(v, dict):
            out[k] = lora_entry(v)
    return out
