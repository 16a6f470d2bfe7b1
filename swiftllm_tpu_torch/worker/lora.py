"""Multi-LoRA: load HF-peft adapters into stacked, step-resident tensors.

A copy of ``swiftllm_tpu/worker/lora.py`` for the PyTorch port (the peft
reader, ``load_lora_adapters`` and ``make_dummy_loras``, the same numpy
arrays bit for bit). All adapters of one serving process live STACKED in
the params: ``layers["lora_<key>"] = {"A": [L, n_lora, r, in], "B": [L,
n_lora, out, r]}``; ``models/llama.py:lora_add`` computes every adapter's
low-rank update for every token as two GEMMs over the stacked adapters and
scales each token's own adapter by its slot (the others by 0).

Adapter slot 0 means "base model"; slot s >= 1 selects stack index s-1.
Adapters with rank < the stack rank are zero-padded (their scale keeps the
TRUE alpha/r). Per-peft convention, scaling = lora_alpha / r.
"""

from __future__ import annotations

import json
import os

import numpy as np

from swiftllm_tpu_torch.config import LlamaModelConfig

# HF peft module name → our projection key.
TARGET_MAP = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}

# [in_dim, out_dim] per key, from the model config.
def _dims(mc: LlamaModelConfig, nkv_eff: int) -> dict[str, tuple[int, int]]:
    D, hd, F = mc.hidden_size, mc.head_dim, mc.ffn_inter_dim
    nq = mc.num_q_heads
    return {
        "wq": (D, nq * hd), "wk": (D, nkv_eff * hd), "wv": (D, nkv_eff * hd),
        "wo": (nq * hd, D),
        "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
    }


def _read_adapter(path: str):
    """One peft checkpoint → (config dict, {(layer, key) → (A [r,in], B [out,r])})."""
    with open(os.path.join(path, "adapter_config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    from safetensors import safe_open
    tensors = {}
    with safe_open(os.path.join(path, "adapter_model.safetensors"),
                   framework="np") as f:
        for name in f.keys():
            tensors[name] = f.get_tensor(name)
    mats: dict[tuple[int, str], dict[str, np.ndarray]] = {}
    for name, t in tensors.items():
        if ".lora_A." in name:
            half = "A"
        elif ".lora_B." in name:
            half = "B"
        else:
            continue
        if "layers." not in name:
            raise ValueError(
                f"unsupported LoRA tensor {name!r}: only per-layer projection "
                f"adapters are supported (no embed/lm_head LoRA)")
        layer = int(name.split("layers.")[1].split(".")[0])
        module = name.split(f".lora_{half}.")[0].rsplit(".", 1)[-1]
        key = TARGET_MAP.get(module)
        if key is None:
            raise ValueError(f"unsupported LoRA target module {module!r}")
        mats.setdefault((layer, key), {})[half] = np.asarray(t)
    return cfg, mats


def load_lora_adapters(paths: dict[str, str], mc: LlamaModelConfig,
                       nkv_eff: int, dtype) -> tuple[dict, np.ndarray,
                                                     dict[str, int],
                                                     tuple[str, ...]]:
    """Load + stack adapters. Returns (layers_entries, scales [n_lora],
    name→slot (slots start at 1; 0 = base), target keys tuple).

    layers_entries maps "lora_<key>" → {"A": [L, n, r, in], "B": [L, n, out, r]}
    host arrays in ``dtype``. KV-head replication (tp > num_kv_heads) is
    applied to wk/wv B halves like the base weights (weights.py)."""
    adapters = [(name, *_read_adapter(p)) for name, p in paths.items()]
    n = len(adapters)
    max_r = max(int(a[1]["r"]) for a in adapters)
    targets: set[str] = set()
    for _, cfg, mats in adapters:
        targets |= {k for (_, k) in mats.keys()}
    targets_t = tuple(sorted(targets))
    dims = _dims(mc, nkv_eff)
    L = mc.num_layers
    rep = nkv_eff // mc.num_kv_heads

    entries: dict[str, dict[str, np.ndarray]] = {}
    for key in targets_t:
        din, dout = dims[key]
        A = np.zeros((L, n, max_r, din), dtype)
        B = np.zeros((L, n, dout, max_r), dtype)
        for s, (_, cfg, mats) in enumerate(adapters):
            for layer in range(L):
                m = mats.get((layer, key))
                if m is None:
                    continue
                a, b = m["A"], m["B"]
                if key in ("wk", "wv") and rep > 1:
                    # replicate KV-head output rows to match the base layout
                    b = b.reshape(mc.num_kv_heads, mc.head_dim, -1)
                    b = np.repeat(b, rep, axis=0).reshape(-1, b.shape[-1])
                assert a.shape[1] == din and b.shape[0] == dout, \
                    (key, a.shape, b.shape, din, dout)
                A[layer, s, :a.shape[0], :] = a.astype(dtype)
                B[layer, s, :, :b.shape[1]] = b.astype(dtype)
        entries["lora_" + key] = {"A": A, "B": B}

    scales = np.asarray([float(c["lora_alpha"]) / float(c["r"])
                         for _, c, _ in adapters], np.float32)
    slots = {name: s + 1 for s, (name, _, _) in enumerate(adapters)}
    return entries, scales, slots, targets_t


def make_dummy_loras(names: list[str], mc: LlamaModelConfig, nkv_eff: int,
                     dtype, r: int = 8,
                     targets: tuple[str, ...] = ("wq", "wv", "wo")) -> tuple[
                         dict, np.ndarray, dict[str, int], tuple[str, ...]]:
    """Deterministic random adapters (no files) for tests and benches.

    Deliberately LOUD (2.0-std halves): dummy base weights are ±1e-3 uniform
    and the logit scale is ~1e-6, so a realistic-magnitude adapter wouldn't
    move a dummy model's argmax — tests need routing to visibly change
    outputs (measured: 0.2-std halves shift dummy logits by only ~1%)."""
    dims = _dims(mc, nkv_eff)
    L, n = mc.num_layers, len(names)
    rng = np.random.default_rng(1234)
    entries = {}
    for key in targets:
        din, dout = dims[key]
        entries["lora_" + key] = {
            "A": (rng.standard_normal((L, n, r, din)) * 2.0).astype(dtype),
            "B": (rng.standard_normal((L, n, dout, r)) * 2.0).astype(dtype),
        }
    scales = np.full(n, 2.0, np.float32)   # alpha/r = 2
    slots = {name: s + 1 for s, name in enumerate(names)}
    return entries, scales, slots, tuple(targets)
