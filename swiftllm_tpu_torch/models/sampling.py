"""Token sampling for the PyTorch port: the exact greedy head at tp = 1.

Port of ``exact_greedy`` in ``swiftllm_tpu/models/sampling.py``. Temperature,
top-k and top-p sampling (``sample_tokens``) are not ported yet; the engine
refuses a request with temperature > 0.
"""

from __future__ import annotations

import torch


def exact_greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab, the first index on ties (as ``jnp.argmax``).
    logits: f32[B, V] -> i32[B]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
