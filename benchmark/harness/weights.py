"""A configuration's weights, drawn on the device from the run's seed.

One generator on the card, one call a kind of weight for all layers at once
(``[L, ...]`` stacks), in bf16, the type they are served in; nothing is
made on the host. The same seed draws the same values, so the reference
draws them again once the program's state is gone. The ``init`` section of
a configuration file sets the draw: projections and embeddings N(0,
``std``), norm weights N(1, ``norm_std``), q/k/v biases N(0, ``bias_std``).
"""

from __future__ import annotations

import torch

from harness.traffic import seed_words


def shapes(w: dict) -> tuple[dict, dict]:
    """(a layer's weights, the other weights) as [out, in] shapes, from the
    reference's widths."""
    D, qd, kd, F, V = (w["D"], w["n_q"] * w["hd"], w["n_kv"] * w["hd"],
                       w["F"], w["V"])
    layer = {"attn_norm": (D,), "wq": (qd, D), "wk": (kd, D), "wv": (kd, D),
             "wo": (D, qd), "ffn_norm": (D,), "w_gate": (F, D), "w_up": (F, D),
             "w_down": (D, F)}
    if w["bias"]:
        layer.update(bq=(qd,), bk=(kd,), bv=(kd,))
    top = {"embed": (V, D), "final_norm": (D,)}
    if not w["tied"]:
        top["lm_head"] = (V, D)
    return layer, top


def draw(w: dict, init: dict, seed: int, device) -> dict:
    """The weights ``{"layers": {name: [L, ...]}, "embed", "lm_head",
    "final_norm"}`` for ``seed``, bf16 on ``device`` (``lm_head`` is the
    embedding where the model ties them)."""
    words = seed_words(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(words[0] | (words[1] << 32))
    layer, top = shapes(w)

    def make(shape, name):
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        if "norm" in name:
            return t.normal_(1.0, init["norm_std"], generator=gen)
        if name in ("bq", "bk", "bv"):
            return t.normal_(0.0, init["bias_std"], generator=gen)
        return t.normal_(0.0, init["std"], generator=gen)

    out = {"layers": {k: make((w["L"],) + s, k) for k, s in layer.items()}}
    out.update({k: make(s, k) for k, s in top.items()})
    if w["tied"]:
        out["lm_head"] = out["embed"]
    return out
