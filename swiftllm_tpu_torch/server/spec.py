"""Prompt-lookup draft proposal for speculative decoding.

Beyond-reference capability (the reference decodes strictly one token per
step, swiftllm/server/engine.py:16-181). Drafts come from the request's OWN
context — the "prompt lookup decoding" scheme: if the sequence's trailing
n-gram occurred earlier, propose the tokens that followed it. No draft model,
no extra weights; acceptance is verified by the target model itself in one
multi-token step, so the output stream is bit-identical to plain greedy
decoding (speculation only changes how many tokens each step confirms).

Data-plane fit: a verify step is a ragged multi-token span — exactly the contract
the chunked-prefill tile kernel and the mixed-step batch builder already
serve. Speculation therefore adds no new kernel; it adds a sampling-head
variant that reads EVERY span position (models/llama.py sample_span) and a
host-side accept loop (server/engine.py).

The matcher is vectorized numpy over a per-request growable token buffer:
O(context) per proposal with ~3 vector ops per n-gram size, no Python token
loops.

Copied from ``swiftllm_tpu/server/spec.py``: the scheduler's drafting path
calls ``sync_state`` and ``propose``, and the engine's EOS rollback
``rollback_state``. The verify step runs on the port's rope kernel's span
write and its ``paged_prefill_attention`` kernel, whose spans may start
anywhere.
"""

from __future__ import annotations

import numpy as np


class SpecState:
    """Per-request token history as a growable int32 numpy buffer."""

    __slots__ = ("buf", "n")

    def __init__(self, capacity: int = 256):
        self.buf = np.empty(capacity, np.int32)
        self.n = 0

    def extend(self, tokens) -> None:
        m = len(tokens)
        if self.n + m > len(self.buf):
            cap = max(len(self.buf) * 2, self.n + m)
            nb = np.empty(cap, np.int32)
            nb[: self.n] = self.buf[: self.n]
            self.buf = nb
        self.buf[self.n : self.n + m] = tokens
        self.n += m

    def view(self) -> np.ndarray:
        return self.buf[: self.n]


def sync_state(request) -> SpecState | None:
    """Bring the request's SpecState up to date with all_token_ids
    (prompt + resolved outputs). Returns None while any needed token is
    still unresolved (pipelined value pending on device)."""
    st = getattr(request, "spec_state", None)
    if st is None:
        st = SpecState(max(256, request.prompt_len + 64))
        request.spec_state = st
    total = request.prompt_len + len(request.output_token_ids)
    if st.n < total:
        tail = (request.prompt_token_ids[st.n:]
                if st.n < request.prompt_len else [])
        need = request.output_token_ids[max(0, st.n - request.prompt_len):]
        if any(t is None for t in need):
            return None
        st.extend(tail + need)
    return st


def rollback_state(request, new_total: int) -> None:
    """Shrink the buffer after EOS truncation / abort replay."""
    st = getattr(request, "spec_state", None)
    if st is not None and st.n > new_total:
        st.n = new_total


def propose(tokens: np.ndarray, k: int, ngram_max: int = 3,
            ngram_min: int = 2, lookback: int = 8192) -> list[int]:
    """Propose ≤k draft tokens continuing `tokens` by longest-suffix n-gram
    lookup. Tries n-gram sizes from ngram_max down to ngram_min and returns
    the continuation after the MOST RECENT earlier occurrence of the longest
    matching suffix; [] if nothing matches. `lookback` bounds the scan (the
    vectorized match is O(context), so an unbounded context would make
    drafting cost grow without limit)."""
    if tokens.shape[0] > lookback:
        tokens = tokens[-lookback:]
    L = int(tokens.shape[0])
    if k <= 0 or L < ngram_min + 1:
        return []
    for n in range(min(ngram_max, L - 1), ngram_min - 1, -1):
        pat = tokens[L - n:]
        # candidate start positions i in [0, L-n): window tokens[i:i+n] == pat,
        # continuation starts at i+n (strictly before the suffix itself).
        m = L - n   # number of candidate windows (the suffix itself excluded)
        if m <= 0:
            continue
        hit = tokens[:m] == pat[0]
        for j in range(1, n):
            hit &= tokens[j : m + j] == pat[j]
        idx = np.nonzero(hit)[0]
        if idx.size == 0:
            continue
        i = int(idx[-1])                 # most recent occurrence
        cont = tokens[i + n : min(i + n + k, L)]
        if cont.size:
            return cont.tolist()
    return []
