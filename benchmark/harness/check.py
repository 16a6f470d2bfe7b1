"""The comparison that decides a run's ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed and with the longest
of them in it, is run through the plain reference (``reference/``) once:
each prompt with the tokens the program served, in float32, from weights
that the reference draws again from the seed and rounds itself as the
configuration states. The number compared is the widest gap by which a
served token's logit lies below the reference's best at its position: 0
for a token the reference would pick too, and up to the width of the
logits for a wrong one. Greedy traffic only: every request is greedy.

The control (``control``) reads the same gap for the token that the
reference in the precision below the configuration's puts first at each
position of the same prompts and tokens: it must fail the limit.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from harness import weights as bench_weights
from harness.traffic import seed_words


def sample(done: list, n: int, seed: int) -> list:
    """``n`` finished requests drawn from the seed, the longest among them."""
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + r.output_len, r.k))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(seed_words(seed) + [7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the best, [n]."""
    return ref.max(dim=1).values - ref.gather(1, chosen[:, None])[:, 0]


def compare(cfg: dict, widths: dict, seed: int, reqs: list, n: int,
            device, control: str | None = None) -> dict:
    """The readings of a run: ``max_logit_gap`` over the served tokens of
    the sample (and the control's, ``control_max_logit_gap``, when asked),
    with the tokens compared and the share the reference would also pick."""
    picked = sample([r for r in reqs if r.done], n, seed)
    if not picked:
        return {"tokens_compared": 0}
    ref_mod = importlib.import_module(f"reference.{cfg['reference']}")
    drawn = bench_weights.draw(widths, cfg["init"], seed, device)
    seqs = [r.prompt + r.tokens[:-1] for r in picked]
    wants = [range(r.prompt_len - 1, r.prompt_len - 1 + len(r.tokens))
             for r in picked]
    served = torch.tensor([t for r in picked for t in r.tokens], device=device)
    ref = torch.cat(ref_mod.logits_at(cfg["published"], drawn, seqs, wants,
                                      precision=cfg["precision"]))
    g = gaps(ref, served)
    out = {"max_logit_gap": float(g.max()),
           "tokens_compared": int(served.numel()),
           "requests_compared": len(picked),
           "top1_share": float((g == 0).float().mean())}
    if control:
        low = torch.cat(ref_mod.logits_at(cfg["published"], drawn, seqs, wants,
                                          precision=control))
        out["control_max_logit_gap"] = float(gaps(ref, low.argmax(dim=1)).max())
    return out
