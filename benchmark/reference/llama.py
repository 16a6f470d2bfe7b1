"""The plain reference of the Llama family as the benchmark runs it: Llama,
Qwen2 (biases on q, k and v) and Mistral (a sliding window), in float32.

It takes the published configuration (the keys of a model's
``config.json``) and the weights as the benchmark drew them (``{"layers":
{name: [L, ...]}, "embed", "lm_head", "final_norm"}``, the projections in
the ``[out, in]`` layout), and works out by itself whatever the configuration
derives from them: the weights of a quantized configuration (``precision``
"int8": a symmetric scale a weight row, amax / 127, the embedding left as
drawn), the rotary tables, the attention masks. It imports nothing of the
program under test, no JAX, and no kernel: plain ``torch`` operations, with
TF32 turned off so that a float32 product is one.

``precision`` names how the weights (and, for "fp8", the products' inputs)
are rounded before float32 arithmetic: "bf16" (as drawn), "int8" and "int4"
(a symmetric scale a weight row), "fp8" (e4m3 with a scale a weight row and
a scale a token row of each product's input). The comparison that decides a
run's ``correct`` uses the configuration's own precision; the control of that
comparison the one below it.

Departures from the published description: none in the mathematics. The
computation runs layer by layer over every given sequence at once, and
attention over blocks of queries, so that it fits beside nothing else on
the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Queries attended at a time (a block of scores is heads x this x keys).
QUERY_BLOCK = 1024
# Vocabulary rows of the head multiplied at a time.
HEAD_BLOCK = 32768


def f32_products() -> None:
    """Float32 products in full float32 (no TF32), on the card too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def widths(cfg: dict) -> dict:
    """The sizes the forward needs, from the published keys."""
    n_q = cfg["num_attention_heads"]
    family = cfg.get("model_type", "llama")
    window = cfg.get("sliding_window") or 0
    if family == "qwen2" and not cfg.get("use_sliding_window", False):
        window = 0
    if family == "llama":
        window = 0
    if cfg.get("rope_scaling"):
        raise NotImplementedError("rope_scaling is not part of the reference")
    if cfg.get("hidden_act", "silu") != "silu":
        raise NotImplementedError("only SiLU MLPs")
    return dict(
        L=cfg["num_hidden_layers"], D=cfg["hidden_size"], n_q=n_q,
        n_kv=cfg.get("num_key_value_heads", n_q),
        hd=cfg.get("head_dim") or cfg["hidden_size"] // n_q,
        F=cfg["intermediate_size"], V=cfg["vocab_size"],
        eps=cfg.get("rms_norm_eps", 1e-6), theta=cfg.get("rope_theta", 10000.0),
        window=window, bias=family == "qwen2" or bool(cfg.get("attention_bias")),
        tied=bool(cfg.get("tie_word_embeddings", False)))


def quantize_rows(w: torch.Tensor, levels: int) -> torch.Tensor:
    """w rounded to ``levels`` steps either side of 0 with a scale a row
    (amax / levels), returned dequantized in float32."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=-1, keepdim=True) / levels, 1e-12)
    return torch.clamp(torch.round(w / s), -levels, levels) * s


FP8_MAX = 448.0


def fp8_rows(w: torch.Tensor) -> torch.Tensor:
    """w in float8 e4m3 with a scale a row (amax / 448), back in float32."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=-1, keepdim=True) / FP8_MAX, 1e-12)
    return (w / s).to(torch.float8_e4m3fn).float() * s


PRECISIONS = ("bf16", "int8", "int4", "fp8")


def weight(w: torch.Tensor, precision: str) -> torch.Tensor:
    """A projection's weight [out, in] as ``precision`` rounds it, in f32."""
    if precision == "bf16":
        return w.float()
    if precision == "int8":
        return quantize_rows(w, 127)
    if precision == "int4":
        return quantize_rows(w, 7)
    if precision == "fp8":
        return fp8_rows(w)
    raise ValueError(f"unknown precision {precision!r}")


def linear(x: torch.Tensor, w32: torch.Tensor, precision: str) -> torch.Tensor:
    """x [n, in] @ w32ᵀ in float32; under "fp8" x is rounded to e4m3 with a
    scale a row first."""
    if precision == "fp8":
        x = fp8_rows(x)
    return x @ w32.T


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x [n, heads, hd] at positions pos [n],
    its angles in float64."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> torch.Tensor:
    """Causal attention of one sequence: q [n, n_q, hd], k and v [n, n_kv,
    hd]; query head h reads kv head h // group. With ``window`` a query at
    position p sees the keys at positions (p - window, p]."""
    n, n_q, hd = q.shape
    group = n_q // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for q0 in range(0, n, QUERY_BLOCK):
        q1 = min(n, q0 + QUERY_BLOCK)
        k0 = max(0, q0 - window + 1) if window else 0
        qp = torch.arange(q0, q1, device=q.device)[:, None]
        kp = torch.arange(k0, q1, device=q.device)[None, :]
        mask = kp <= qp
        if window:
            mask &= kp > qp - window
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[k0:q1]) * scale
        s = s.masked_fill(~mask[None], float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                  v[k0:q1])
    return out


def layer_weights(weights: dict, layer: int, precision: str) -> dict:
    """One layer's weights in float32 as ``precision`` rounds them (norms and
    biases as drawn)."""
    out = {}
    for name, stack in weights["layers"].items():
        w = stack[layer]
        out[name] = (weight(w, precision) if w.dim() == 2 else w.float())
    return out


def logits_at(cfg: dict, weights: dict, seqs: list, wants: list, *,
              precision: str) -> list:
    """For each sequence of token ids ``seqs[i]`` (a list of ints), the
    float32 logits [len(wants[i]), V] that predict the token after each
    position in ``wants[i]`` (a range of positions of that sequence)."""
    f32_products()
    w = widths(cfg)
    dev = weights["embed"].device
    lens = [len(s) for s in seqs]
    ids = torch.tensor([t for s in seqs for t in s], device=dev)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    x = weights["embed"][ids].float()                           # [N, D]
    hd, n_q, n_kv = w["hd"], w["n_q"], w["n_kv"]
    for layer in range(w["L"]):
        lw = layer_weights(weights, layer, precision)
        h = rms_norm(x, lw["attn_norm"], w["eps"])
        q = linear(h, lw["wq"], precision)
        k = linear(h, lw["wk"], precision)
        v = linear(h, lw["wv"], precision)
        if w["bias"]:
            q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
        q = rope(q.view(-1, n_q, hd), pos, w["theta"])
        k = rope(k.view(-1, n_kv, hd), pos, w["theta"])
        v = v.view(-1, n_kv, hd)
        attn = torch.empty_like(q)
        start = 0
        for n in lens:
            sl = slice(start, start + n)
            attn[sl] = attention(q[sl], k[sl], v[sl], w["window"])
            start += n
        x = x + linear(attn.reshape(-1, n_q * hd), lw["wo"], precision)
        h = rms_norm(x, lw["ffn_norm"], w["eps"])
        gate = F.silu(linear(h, lw["w_gate"], precision))
        x = x + linear(gate * linear(h, lw["w_up"], precision), lw["w_down"],
                       precision)
        del lw, h, q, k, v, attn, gate
    starts, at = [], 0
    for n in lens:
        starts.append(at)
        at += n
    rows = torch.tensor([s0 + p for s0, want in zip(starts, wants) for p in want],
                        device=dev, dtype=torch.long)
    h = rms_norm(x[rows], weights["final_norm"], w["eps"])
    head = weights["embed"] if w["tied"] else weights["lm_head"]
    # The head is a projection like the others (a quantized configuration
    # quantizes an untied head); a tied head is the embedding as drawn.
    head_precision = "bf16" if w["tied"] else precision
    logits = torch.cat([linear(h, weight(head[v0:v0 + HEAD_BLOCK], head_precision),
                               head_precision)
                        for v0 in range(0, w["V"], HEAD_BLOCK)], dim=1)
    out, at = [], 0
    for want in wants:
        out.append(logits[at:at + len(want)])
        at += len(want)
    return out
