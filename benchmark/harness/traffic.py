"""The one traffic generator. A traffic file gives its parameters:

- ``loop``: "open" (requests due on a schedule, whether or not earlier ones
  finished) with ``rate_per_s`` and ``arrivals`` "poisson"; or "closed"
  with ``clients`` (each sends its next request when its last one ends)
  and ``pool`` (the most requests a window can take).
- ``prompt_len`` and ``output_len``: each ``{"dist": "lognormal", "median",
  "sigma", "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``.
- ``check_requests``: how many finished requests the comparison with the
  reference takes (the longest among them).

Every seed is given the same work in another order. The requests come in
blocks of ``BLOCK``; in block b, the lengths sit at the quantiles u = (j +
v(b)) / BLOCK, j = 0 .. BLOCK - 1, of their distributions, where v is the
van der Corput sequence (base 2 for prompts, 3 for outputs), and the seed
only orders them within the block (prompts and outputs apart). So every
seed's first n blocks hold the same lengths, and every prefix spreads over
the whole distribution, as a closed loop, which takes a prefix, needs. An
open loop's N = round(rate x seconds) gaps are the N quantiles (i + 1/2) /
N of the exponential distribution, in an order drawn from the seed, so that
every seed's arrivals span the same time. Prompt tokens are drawn from
(seed, k) over the vocabulary but its first id.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

BLOCK = 8     # requests whose lengths are the same for every seed

@dataclasses.dataclass
class Req:
    """One request: its index, lengths and (open loop) its due time from the
    window's start, then what happened to it."""
    k: int
    prompt_len: int
    output_len: int
    due_s: float | None = None         # due, from the window's start
    prompt: list | None = None
    due: float | None = None           # host clock when due
    sent: float | None = None          # host clock when submitted
    stamps: list = dataclasses.field(default_factory=list)  # token arrivals
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def seed_words(seed: int) -> list:
    """A seed of any size as non-negative 32-bit words for numpy."""
    seed = int(seed) % (1 << 64)
    return [seed & 0xFFFFFFFF, seed >> 32]


def van_der_corput(k: int, base: int) -> float:
    q, denom = 0.0, 1.0
    k += 1
    while k:
        k, r = divmod(k, base)
        denom *= base
        q += r / denom
    return q


def quantile(dist: dict, u: float) -> int:
    """The length at quantile u (0 < u < 1) of ``dist``, clipped, whole."""
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(u))
    elif dist["dist"] == "uniform":
        x = lo + (hi - lo + 1) * u - 0.5
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return int(min(hi, max(lo, round(x))))


class Traffic:
    """The requests of one run of a traffic mix, made on demand."""

    def __init__(self, params: dict, seed: int, vocab: int):
        self.params = params
        self.seed = seed
        self.vocab = vocab

    def _u(self, k: int, which: int) -> float:
        """Request k's quantile of its prompt (which 0) or output (1)."""
        b, j = divmod(k, BLOCK)
        order = np.random.default_rng(seed_words(self.seed) + [b, which]
                                      ).permutation(BLOCK)
        return (order[j] + van_der_corput(b, 2 + which)) / BLOCK

    def lengths(self, k: int) -> tuple[int, int]:
        p = self.params
        return (quantile(p["prompt_len"], self._u(k, 0)),
                quantile(p["output_len"], self._u(k, 1)))

    def request(self, k: int) -> Req:
        n, m = self.lengths(k)
        rng = np.random.default_rng(seed_words(self.seed) + [k])
        prompt = rng.integers(1, self.vocab, size=n).tolist()
        return Req(k=k, prompt_len=n, output_len=m, prompt=prompt)

    def open_schedule(self, seconds: float) -> list:
        """An open loop's requests for a window of ``seconds``, with their
        due times."""
        p = self.params
        assert p["loop"] == "open" and p["arrivals"] == "poisson", p
        rate = float(p["rate_per_s"])
        n = max(1, round(rate * seconds))
        gaps = np.array([-math.log(1 - (i + 0.5) / n) / rate for i in range(n)])
        order = np.random.default_rng(seed_words(self.seed) + [1 << 31]).permutation(n)
        due = np.concatenate([[0.0], np.cumsum(gaps[order])[:-1]])
        out = []
        for k in range(n):
            r = self.request(k)
            r.due_s = float(due[k])
            out.append(r)
        return out
